"""The port's copy of the ExaNet interconnect model's framework-free layers.

So far: :mod:`repro_torch.core.exanet.params` (the prototype's calibrated
constants), :mod:`repro_torch.core.exanet.schedules` (the collective
schedules and their alpha-beta cost),
:mod:`repro_torch.core.exanet.allreduce_accel` (the section 4.7
accelerator's closed form) and
:mod:`repro_torch.core.exanet.schedule_algebra` (the round algebra the
synthesized schedules are written in): what the collective planner and the
section 7 evaluation read. The topology, the event engine, the compiled
executors and the MPI layer follow when a slice first needs them.
"""

from repro_torch.core.exanet.params import DEFAULT, HwParams, scaled_params
from repro_torch.core.exanet.schedules import (CollectiveSchedule, Round,
                                               alpha_beta_cost_s)
from repro_torch.core.exanet.allreduce_accel import (accel_allreduce_latency,
                                                     accel_applicable)

__all__ = [
    "DEFAULT", "HwParams", "scaled_params", "CollectiveSchedule", "Round",
    "alpha_beta_cost_s", "accel_allreduce_latency", "accel_applicable",
]
