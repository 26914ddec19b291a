"""Cross-cutting utilities (ref: tasks/R2R-judy/src/utils/__init__.py).

The port of ``curriculum_learning_for_vln_tpu/utils/__init__.py``: the
same names.  Its modules import numpy, torch and no other module of the
port, so the facade adds no import cycle and no heavy import (the
TensorBoard writer loads its protobufs only when a writer opens)."""
from .angles import (ANGLE_INC, all_loc_embeddings, build_viewpoint_loc_embedding,
                     canonical_angle, heading_to_view_index, make_angle_feat,
                     make_angle_feat_np, view_elevation, view_heading)
from .config import CfgNode, get_cfg_defaults
from .floyd import FloydGraph
from .glove import load_glove
from .logging_utils import (ScalarWriter, clean_dir, format_score_table,
                            get_main_logger, pretty_json_dump, prettyprint)
from .metrics import CLS, DTW, batched_ndtw_sdtw, path_length
from .profiling import StepTimer, trace
from .region_label import REGION_LABELS, load_room_connectivity
from .tokenizer import (BASE_VOCAB, BOS_IDX, EOS_IDX, PAD_IDX, UNK_IDX,
                        Tokenizer, build_vocab, read_vocab, split_sentence,
                        write_vocab)

__all__ = [
    "ANGLE_INC", "all_loc_embeddings", "build_viewpoint_loc_embedding",
    "canonical_angle", "heading_to_view_index", "make_angle_feat",
    "make_angle_feat_np", "view_elevation", "view_heading",
    "CfgNode", "get_cfg_defaults", "FloydGraph", "load_glove",
    "ScalarWriter", "clean_dir", "format_score_table", "get_main_logger",
    "pretty_json_dump", "prettyprint", "CLS", "DTW", "batched_ndtw_sdtw",
    "path_length", "StepTimer", "trace", "REGION_LABELS",
    "load_room_connectivity", "BASE_VOCAB", "BOS_IDX", "EOS_IDX", "PAD_IDX",
    "UNK_IDX", "Tokenizer", "build_vocab", "read_vocab", "split_sentence",
    "write_vocab",
]
