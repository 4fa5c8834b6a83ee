"""The port's copy of the ExaNet interconnect model (the paper's Layer A).

It reproduces the ExaNeSt prototype's measured communication behaviour
(Tables 1-2, Figs. 13-19) from component-level constants, as the
reference's ``repro.core.exanet`` does, module for module:

* :mod:`~repro_torch.core.exanet.params` — the calibrated constants;
* :mod:`~repro_torch.core.exanet.faults` and
  :mod:`~repro_torch.core.exanet.topology` — the degraded-machine model,
  the QFDB/mezzanine torus and its routes;
* :mod:`~repro_torch.core.exanet.sim` and
  :mod:`~repro_torch.core.exanet.network` — the discrete-event engine and
  the eager/rendez-vous transports;
* :mod:`~repro_torch.core.exanet.schedules`,
  :mod:`~repro_torch.core.exanet.schedule_algebra` and
  :mod:`~repro_torch.core.exanet.allreduce_accel` — collective schedules,
  their round algebra and the §4.7 accelerator's closed form;
* :mod:`~repro_torch.core.exanet.exec_compiled` and
  :mod:`~repro_torch.core.exanet.program_compiled` — the compiled
  executors, which replay schedules and whole programs as array scans;
* :mod:`~repro_torch.core.exanet.scan_engine` — their scan lanes:
  ``"numpy"`` (the default, host code) and ``"torch"`` (float64 torch ops
  on the card, in place of the reference's jax lane);
* :mod:`~repro_torch.core.exanet.mpi` — :class:`ExanetMPI`, the MPI layer
  and OSU-style microbenchmarks over all of the above;
* the studies built on it: :mod:`~repro_torch.core.exanet.apps` (the
  section 6.2 applications and Table 3),
  :mod:`~repro_torch.core.exanet.interference` (two tenants on shared
  QFDBs) and :mod:`~repro_torch.core.exanet.ip_overlay` (the section 5.3
  IP overlay).

Two changes from the reference, both in ROADMAP.md's record of the port's
differences: the torch scan lane, and ``program_compiled._lower_coll``
resolving synthesized schedule names as the interpreter does.
"""

from repro_torch.core.exanet.params import DEFAULT, HwParams, scaled_params
from repro_torch.core.exanet.topology import Topology, Path
from repro_torch.core.exanet.sim import Engine, Resource, TraceEvent
from repro_torch.core.exanet.network import Network
from repro_torch.core.exanet.schedules import (CollectiveSchedule, Round,
                                               alpha_beta_cost_s)
from repro_torch.core.exanet.exec_compiled import (BatchScheduleResult,
                                                   ProgramStructureError,
                                                   RoundProgram)
from repro_torch.core.exanet.program_compiled import (CompiledProgram,
                                                      compile_program_ir)
from repro_torch.core.exanet.mpi import ExanetMPI, BcastResult, ScheduleResult
from repro_torch.core.exanet.allreduce_accel import (accel_allreduce_latency,
                                                     accel_applicable)

__all__ = [
    "DEFAULT", "HwParams", "scaled_params", "Topology", "Path", "Engine",
    "Resource", "TraceEvent", "Network", "CollectiveSchedule", "Round",
    "alpha_beta_cost_s", "BatchScheduleResult", "ProgramStructureError",
    "RoundProgram", "CompiledProgram", "compile_program_ir",
    "ExanetMPI", "BcastResult", "ScheduleResult",
    "accel_allreduce_latency", "accel_applicable",
]
