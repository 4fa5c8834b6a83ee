"""Serving stack: the engine (:mod:`repro_torch.serve.engine`) and its
simulated twin on the event engine (:mod:`repro_torch.serve.sim`,
:mod:`repro_torch.serve.traffic`).

Names load lazily, as in the reference's ``repro.serve``, so the
numpy-only simulator side imports without ``torch.cuda``.
"""

__all__ = ["ServeEngine", "Request", "ServeSim", "ServeSimSpec",
           "StepTable"]


def __getattr__(name):
    if name in ("ServeEngine", "Request"):
        from repro_torch.serve import engine
        return getattr(engine, name)
    if name in ("ServeSim", "ServeSimSpec", "StepTable"):
        from repro_torch.serve import sim
        return getattr(sim, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
