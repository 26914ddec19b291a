"""Training engines (ref: tasks/R2R-judy/src/engine/__init__.py).  Every
name the JAX package's ``engine/__init__.py`` exports that has a torch
counterpart, under the same name.  Its jit-step builders have none:
``build_train_step``'s job is ``loop.one_iter`` (and ``agent_one_iter``,
``packed_one_iter``), ``build_backtranslation_step``'s is
``backtranslation_step``; ``build_eval_rollout`` keeps its name."""
from .auto_curriculum import AutoCurriculum, Exp3S
from .checkpoint import load_checkpoint, save_checkpoint, wait_for_checkpoints
from .curriculum import NaiveCurriculum, SelfPacedCurriculum, spcl_update_lambda, spcl_update_weight
from .evaluator import Evaluation
from .loop import (agent_one_iter, build_eval_rollout, make_optimizer, one_iter, packed_one_iter,
                   run_eval, write_results)
from .pretrain import VLNBertPretrainer, make_clr2r_rounds, pretrain_batches, score_difficulty
from .self_train import backtranslation_step, pretrain_speaker, self_train
from .trainer import ClassicTrainer, check_the_code, dedup_by_path

__all__ = [
    "ClassicTrainer", "NaiveCurriculum", "SelfPacedCurriculum", "Evaluation",
    "check_the_code", "dedup_by_path", "build_eval_rollout", "make_optimizer", "run_eval",
    "save_checkpoint", "load_checkpoint", "wait_for_checkpoints", "spcl_update_weight",
    "spcl_update_lambda", "self_train", "pretrain_speaker", "backtranslation_step",
    "write_results", "VLNBertPretrainer", "pretrain_batches", "score_difficulty",
    "make_clr2r_rounds", "AutoCurriculum", "Exp3S", "one_iter", "agent_one_iter",
    "packed_one_iter",
]
