"""Training of the forecaster and GAN families: the train/eval steps (``steps``), the
trainer (``sequence_trainer``) and its checkpoints (``checkpoint``),
counterparts of the JAX package's ``train/``."""
from .sequence_trainer import SequenceTrainer

__all__ = ["SequenceTrainer"]
