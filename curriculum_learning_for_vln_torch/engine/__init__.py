"""Training engines (ref: tasks/R2R-judy/src/engine/__init__.py).  The
back-translation driver is exported here, as the JAX package's
``engine/__init__.py`` exports it."""
from .self_train import backtranslation_step, pretrain_speaker, self_train

__all__ = ["backtranslation_step", "pretrain_speaker", "self_train"]
