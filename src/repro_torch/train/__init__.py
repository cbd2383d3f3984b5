"""The port's train step (``repro.train``)."""
from .step import TrainProfile, loss_and_grads, make_train_step

__all__ = ["TrainProfile", "loss_and_grads", "make_train_step"]
