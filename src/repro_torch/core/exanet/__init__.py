"""The port's copy of the ExaNet interconnect model's framework-free layers.

So far only :mod:`repro_torch.core.exanet.params` (the prototype's
calibrated constants, read by the section 7 evaluation in
:mod:`repro_torch.roofline.paper`); the topology, the event engine and the
MPI layer follow when a slice first needs them.
"""

from repro_torch.core.exanet.params import DEFAULT, HwParams, scaled_params

__all__ = ["DEFAULT", "HwParams", "scaled_params"]
