"""Collectives on torch.distributed process groups
(:mod:`repro_torch.core.collectives`), and the port's copies of the
reference's framework-free planning layer: the ``CommPolicy`` facade, the
machine model, the collective planner, the Program IR
(:mod:`repro_torch.core.program`) and schedule synthesis
(:mod:`repro_torch.core.synth`)."""

from repro_torch.core.comm import CommPolicy
from repro_torch.core.machine import INTER, INTRA, MachineModel, TpuMachine
from repro_torch.core.planner import (ALLREDUCE_CANDIDATES,
                                      GRAD_SYNC_STRATEGIES,
                                      CollectivePlanner, Plan, TrainSyncPlan,
                                      crossover_bytes, oneshot_cost_s,
                                      ring_cost_s)
from repro_torch.core.program import (Collective, Compute, Irecv, Isend,
                                      Program, ProgramDeadlockError,
                                      ProgramError, Wait, analytic_program_us)

__all__ = [
    "CommPolicy", "INTER", "INTRA", "MachineModel", "TpuMachine",
    "ALLREDUCE_CANDIDATES", "GRAD_SYNC_STRATEGIES", "CollectivePlanner",
    "Plan", "TrainSyncPlan", "crossover_bytes", "oneshot_cost_s",
    "ring_cost_s", "Collective", "Compute", "Irecv", "Isend", "Program",
    "ProgramDeadlockError", "ProgramError", "Wait", "analytic_program_us",
]
