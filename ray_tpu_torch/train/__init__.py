"""Training on one device: the optimizer, the train state and the train
and eval steps of the JAX package's ``train/step.py``."""

from .step import (
    AdamWState,
    Optimizer,
    TrainState,
    init_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "AdamWState",
    "Optimizer",
    "TrainState",
    "init_state",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
]
