"""The port's training path: the train step (:mod:`repro_torch.train.step`)
and the fault-tolerant loop (:mod:`repro_torch.train.loop`)."""
from repro_torch.train.loop import TrainLoop, TrainResult
from repro_torch.train.step import loss_fn, make_train_step

__all__ = ["make_train_step", "loss_fn", "TrainLoop", "TrainResult"]
