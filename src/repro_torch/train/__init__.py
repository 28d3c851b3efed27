"""The fault-tolerant training loop of the port (:mod:`.loop`)."""

from .loop import TrainConfig, Trainer

__all__ = ["TrainConfig", "Trainer"]
