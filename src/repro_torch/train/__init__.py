"""Train step, Trainer and AdamW."""
