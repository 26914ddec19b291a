"""Training engines (ref: tasks/R2R-judy/src/engine/__init__.py).  The
back-translation stage and the ViLBERT pretraining / CLR2R construction
are exported here, as the JAX package's ``engine/__init__.py`` exports
them."""
from .pretrain import VLNBertPretrainer, make_clr2r_rounds, pretrain_batches, score_difficulty
from .self_train import backtranslation_step, pretrain_speaker, self_train

__all__ = ["backtranslation_step", "pretrain_speaker", "self_train", "VLNBertPretrainer",
           "pretrain_batches", "score_difficulty", "make_clr2r_rounds"]
