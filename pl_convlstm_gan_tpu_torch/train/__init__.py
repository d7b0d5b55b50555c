"""Training of the three model families: the train/eval steps (``steps``),
the Generator's ``Trainer`` (``trainer``), the forecaster and GAN
``SequenceTrainer`` (``sequence_trainer``) and their checkpoints
(``checkpoint``), counterparts of the JAX package's ``train/``."""
from .sequence_trainer import SequenceTrainer
from .trainer import Trainer

__all__ = ["SequenceTrainer", "Trainer"]
