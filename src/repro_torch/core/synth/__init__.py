"""Collective-schedule synthesis: semantic verification
(:mod:`repro_torch.core.synth.verify`), population search + winner cache
(:mod:`repro_torch.core.synth.search`) over the round algebra of
:mod:`repro_torch.core.exanet.schedule_algebra`."""
