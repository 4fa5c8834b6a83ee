"""Roofline figures of the card the port runs on, and the paper's section 7
evaluation against them."""
