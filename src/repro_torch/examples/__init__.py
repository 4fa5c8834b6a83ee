"""The reference's examples on the port, one module each, under the
reference's file names: ``python -m repro_torch.examples.<name>`` runs on
``cuda`` unless ``--device cpu`` is given.

* :mod:`~repro_torch.examples.cg_solver` — the miniFE/HPCG analog: a
  conjugate-gradient solve of the 3-D Poisson problem, slabs over ``data``.
* :mod:`~repro_torch.examples.quickstart` — the ExaNet model, the
  hierarchical allreduce on a process mesh, a tiny LM trained.
* :mod:`~repro_torch.examples.allreduce_accel_demo` — the section 4.7
  accelerator as model, ``combine`` kernel and schedule.
* :mod:`~repro_torch.examples.serve_lm` — continuous batching over 4 slots.
* :mod:`~repro_torch.examples.train_lm` — training with an injected failure,
  recovery and the straggler monitor.
"""
