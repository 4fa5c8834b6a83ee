"""Train step, Trainer and AdamW (:mod:`repro_torch.train.loop`,
:mod:`repro_torch.train.optimizer`), and the train-step co-simulator
(:mod:`repro_torch.train.cosim`)."""

from repro_torch.train.cosim import SyncCandidate, TrainSim, TrainStepSpec

__all__ = ["SyncCandidate", "TrainSim", "TrainStepSpec"]
