"""Training substrate: optimizers, microbatched train step, LR schedules."""
from .optimizer import Optimizer, adafactor, adamw, clip_by_global_norm
from .train_step import TrainSpec, lr_schedule, make_train_step
__all__ = ["Optimizer", "TrainSpec", "adafactor", "adamw",
           "clip_by_global_norm", "lr_schedule", "make_train_step"]
