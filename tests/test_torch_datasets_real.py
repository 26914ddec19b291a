"""The real-data branches of the port's pipeline against the JAX package,
on a tiny universe this file writes in the reference's formats (no
download): Matterport-style connectivity JSONs, a base64 ResNet-style
feature TSV, R2R, RxR-en and CLR2R round JSONs, all under a temporary
directory that stands in for the checkout (the R2R splits of a Mixed or
CLR2R run are read from ``assets/`` there).

* ``expand_rxr_items``: JAX's items exactly (one instruction an item,
  keyed by its ``instruction_id``; an unencodable one and an unknown scan
  dropped);
* ``build_environments`` for RxR, Mixed (R2R + RxR training, four
  validation envs), R4R (joins from the R2R JSONs, AGENT.TEACHER path),
  CLR2R under AUTO (the individual rounds) and NAIVE (cumulative): the
  same world, env keys, items, teacher tables and batch order as JAX's;
* ``main.eval_train_envs`` (TRAIN.EVAL_TRAIN): the envs JAX's ``main``
  builds inline (main.py:127-138), for DATA.NAME CLR2R and R2R;
* ``main`` end to end on that universe: CLR2R, AUTO, EVAL_TRAIN, one
  short epoch on the CPU, each round's train split scored before the
  validation splits.

Host arithmetic only: held exactly, but for the world's distances
(within 1e-5: JAX's C++ solver sums the edges in another order).
"""
import json
import os

import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch import main as t_main
from curriculum_learning_for_vln_torch import pipeline as t_pipeline
from curriculum_learning_for_vln_torch.data import datasets as t_ds
from curriculum_learning_for_vln_torch.engine import trainer as t_trainer
from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults as t_cfg
from curriculum_learning_for_vln_tpu import pipeline as j_pipeline
from curriculum_learning_for_vln_tpu.data import datasets as j_ds
from curriculum_learning_for_vln_tpu.data import features as j_ft
from curriculum_learning_for_vln_tpu.env.host_env import R2RBatchEnv as JEnv
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults as j_cfg
from curriculum_learning_for_vln_tpu.utils.tokenizer import build_vocab, write_vocab
from curriculum_learning_for_vln_tpu.world import graph as j_graph
from curriculum_learning_for_vln_tpu.world import synthetic as j_synth

torch.set_num_threads(2)


def _rxr(items, lang="en"):
    """RxR-style items: one instruction each, keyed by instruction_id."""
    return [{"scan": it["scan"], "path_id": it["path_id"], "path": it["path"],
             "heading": it["heading"], "distance": it["distance"],
             "instruction": it["instructions"][0], "instruction_id": f"rxr_{it['path_id']}",
             "language": lang} for it in items]


@pytest.fixture(scope="module")
def universe(tmp_path_factory):
    root = tmp_path_factory.mktemp("universe")
    graphs = j_synth.make_world_graphs(num_scans=2, nodes_per_scan=20, seed=13)
    for g in graphs.values():
        j_graph.write_connectivity(g, str(root / "connectivity"))
    j_ft.write_feature_tsv(str(root / "feats.tsv"), {
        f"{scan}_{vid}": j_synth.synthetic_features(f"{scan}_{vid}", 36, 64)
        for scan, g in graphs.items() for vid in g.node_ids})
    splits = {"train": j_synth.make_r2r_dataset(graphs, num_paths=30, seed=1),
              "val_seen": j_synth.make_r2r_dataset(graphs, num_paths=20, seed=2,
                                                   path_id_base=5000),
              "val_unseen": j_synth.make_r2r_dataset(graphs, num_paths=20, seed=3,
                                                     path_id_base=9000)}
    for d in ("assets/CLR2Rv3", "data/RxR-en"):
        os.makedirs(root / d)
    for split, items in splits.items():
        for d in ("assets", "data"):
            with open(root / d / f"R2R_{split}.json", "w") as f:
                json.dump(items, f)
        with open(root / "data/RxR-en" / f"RxR_{split}.json", "w") as f:
            json.dump(_rxr(items), f)
    per = len(splits["train"]) // 5
    for k in range(1, 6):
        with open(root / "assets/CLR2Rv3" / f"CLR2R_{j_ds.clr2r_split_name(k)}.json", "w") as f:
            json.dump(splits["train"][(k - 1) * per: k * per], f)
    write_vocab(build_vocab(splits["train"], min_count=1), str(root / "assets/vocab.txt"))
    return root


@pytest.fixture()
def at_root(universe, monkeypatch):
    monkeypatch.chdir(universe)  # "assets/..." resolves inside the universe
    return universe


def test_expand_rxr_items_matches_jax(tokenizer, synth_dataset):
    items = _rxr(synth_dataset[:12])
    items[3]["instruction"] = ""  # nothing to encode: dropped
    items[5]["scan"] = "not_featurized"
    allowed = {it["scan"] for it in synth_dataset}
    for scans in (None, allowed):
        got = t_ds.expand_rxr_items(items, tokenizer, scans)
        want = j_ds.expand_rxr_items(items, tokenizer, scans)
        assert len(got) == len(want) == 11 - (scans is not None)
        for g, w in zip(got, want, strict=True):
            assert g.keys() == w.keys() and "instruction" not in g and "instruction_id" not in g
            np.testing.assert_array_equal(g.pop("instr_encoding"), w.pop("instr_encoding"))
            assert g == w
    assert got[0]["instr_id"] == "rxr_" + str(synth_dataset[0]["path_id"])
    assert got[0]["instructions"] == synth_dataset[0]["instructions"][0]


def _cfgs(root, *extra):
    cfgs = []
    for make in (t_cfg, j_cfg):
        cfg = make()
        cfg.merge_from_list(["DATA.DATA_DIR", str(root / "data"), "DATA.IMG_FEAT_DIR",
                             str(root / "feats.tsv"), "DATA.CONNECTIVITY_DIR",
                             str(root / "connectivity"), "DATA.TRAIN_VOCAB",
                             str(root / "assets/vocab.txt"), "DATA.MAX_ENC_LEN", 40,
                             "TRAIN.BATCH_SIZE", 4, *extra])
        cfgs.append(cfg)
    return cfgs


def _same_env(te, je):
    assert te.size() == je.size() > 0 and te.name == je.name
    assert [it["instr_id"] for it in te.data] == [it["instr_id"] for it in je.data]
    np.testing.assert_array_equal(te.instr_tokens, je.instr_tokens)
    np.testing.assert_array_equal(te.path_local, je.path_local)
    np.testing.assert_array_equal(te.path_len, je.path_len)
    for _ in range(3):
        te.next_batch(), je.next_batch()
        np.testing.assert_array_equal(te.cur_batch_index, je.cur_batch_index)


CASES = {
    "RxR": ["DATA.NAME", "RxR", "DATA.DATA_DIR", "{root}/data/RxR-en"],
    "Mixed": ["DATA.NAME", "Mixed"],
    "R4R-path": ["DATA.NAME", "R4R", "DATA.R4R_JOINS", 2, "AGENT.TEACHER", "path"],
    "CLR2R-AUTO": ["DATA.NAME", "CLR2R", "DATA.DATA_DIR", "{root}/assets/CLR2Rv3",
                   "TRAIN.CLMODE", "AUTO"],
    "CLR2R-NAIVE-path": ["DATA.NAME", "CLR2R", "DATA.DATA_DIR", "{root}/assets/CLR2Rv3",
                         "TRAIN.CLMODE", "NAIVE", "AGENT.TEACHER", "path"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_real_environments_match_jax(at_root, case):
    extra = [x.format(root=at_root) if isinstance(x, str) else x for x in CASES[case]]
    t_c, j_c = _cfgs(at_root, *extra)
    t_tok, j_tok = t_pipeline.build_tokenizer(t_c), j_pipeline.build_tokenizer(j_c)
    t_world, t_train, t_valid, t_dim = t_pipeline.build_environments(t_c, t_tok, seed=3,
                                                                     device="cpu")
    j_world, j_train, j_valid, j_dim = j_pipeline.build_environments(j_c, j_tok, seed=3)
    assert t_dim == j_dim == 64 and t_world.num_nodes == j_world.num_nodes == 40
    # JAX compiles real worlds with its C++ shortest-path solver (world/native.py, not
    # ported): the same distances up to f32 rounding
    np.testing.assert_allclose(t_world.dist, j_world.dist, rtol=1e-6, atol=1e-5)
    assert list(t_valid) == list(j_valid)
    if case == "Mixed":
        assert list(t_valid) == ["r2r_val_seen", "r2r_val_unseen", "rxr_val_seen",
                                 "rxr_val_unseen"]
        rxr = [it["instr_id"].startswith("rxr_") for it in t_train.data]
        assert 0 < sum(rxr) < len(rxr)  # both datasets in the one train env
    if isinstance(j_train, dict):
        assert list(t_train) == list(j_train) == [f"round_{k}" for k in range(1, 6)]
        sizes = [t_train[k].size() for k in t_train]
        if "AUTO" in case:  # the rounds themselves, 3 instructions a path
            assert sizes == [6 * 3] * 5
        else:  # cumulative
            assert sizes == [6 * 3 * k for k in range(1, 6)]
        pairs = [(t_train[k], j_train[k]) for k in j_train]
    else:
        pairs = [(t_train, j_train)]
    pairs += [(t_valid[k], j_valid[k]) for k in j_valid]
    for te, je in pairs:
        assert te.teacher_mode == je.teacher_mode
        _same_env(te, je)
    if "path" in case:  # the gt routes packed, P = the longest
        te = t_train["round_5"] if isinstance(t_train, dict) else t_train
        assert te.teacher_mode == "path" and te.path_local.shape[1] > 1


@pytest.mark.parametrize("name", ["CLR2R", "R2R"])
def test_eval_train_envs_match_jax(at_root, name):
    data_dir = at_root / ("assets/CLR2Rv3" if name == "CLR2R" else "data")
    t_c, j_c = _cfgs(at_root, "DATA.NAME", name, "DATA.DATA_DIR", str(data_dir),
                     "TRAIN.EVAL_TRAIN", True)
    t_tok = t_pipeline.build_tokenizer(t_c)
    world, _, _, _ = t_pipeline.build_environments(t_c, t_tok, seed=3, device="cpu")
    got = t_main.eval_train_envs(t_c, t_tok, world, 3, device="cpu")
    # JAX main.py:127-138, inline there
    j_tok = j_pipeline.build_tokenizer(j_c)
    j_world, _, _, _ = j_pipeline.build_environments(j_c, j_tok, seed=3)
    clr_dir = j_c.DATA.DATA_DIR if j_c.DATA.NAME == "CLR2R" else "assets/CLR2Rv3"
    want = {}
    for k in range(1, 6):
        items = j_ds.load_datasets([j_ds.clr2r_split_name(k)], "CLR2R", clr_dir)
        want[f"round_{k}"] = JEnv(j_world, j_ds.expand_r2r_items(items, j_tok,
                                                                 set(j_world.scan_ids)),
                                  j_c.TRAIN.BATCH_SIZE * 2, j_tok, 3 + 100 + k, "train")
    assert list(got) == list(want)
    for k in want:
        assert got[k].batch_size == want[k].batch_size == 8
        _same_env(got[k], want[k])


def test_main_auto_with_eval_train_on_the_real_format_world(at_root, monkeypatch):
    summaries = []
    monkeypatch.setattr(t_trainer, "prettyprint", summaries.append)
    args, cfg = t_main.parse_args(list(map(str, [
        "--device", "cpu", "--seed", "5", "--config-file",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "configs/envdrop/envdrop_cl_config.yaml"),
        "TRAIN.CLMODE", "AUTO", "TRAIN.EVAL_TRAIN", "True", "DATA.DATA_DIR",
        str(at_root / "assets/CLR2Rv3"), "DATA.IMG_FEAT_DIR", str(at_root / "feats.tsv"),
        "DATA.CONNECTIVITY_DIR", str(at_root / "connectivity"), "DATA.TRAIN_VOCAB",
        str(at_root / "assets/vocab.txt"), "DATA.TRAINVAL_VOCAB", "", "DATA.MAX_ENC_LEN", 40,
        "TPU.PRECISION", "f32", "TRAIN.BATCH_SIZE", 4, "TRAIN.MAX_EPOCH", 1,
        "TRAIN.ITER_PER_EPOCH", 2, "TRAIN.EVAL_INTERVAL", 1, "AGENT.MAX_EPISODE_LEN", 5,
        "MODEL.ENVDROP.HIDDEN_SIZE", 32, "MODEL.ENVDROP.WORD_EMB_SIZE", 16,
        "MODEL.ENVDROP.ACT_EMB_SIZE", 16, "OUTPUT.CKPT_DIR", str(at_root / "ckpt"),
        "OUTPUT.LOG_DIR", str(at_root / "logs"), "OUTPUT.TSBOARD_DIR", ""])))
    t_main.check_ported(args, cfg)  # AUTO and EVAL_TRAIN: no longer refused
    t_main.main(args, cfg)
    assert len(summaries) == 2
    train_scores, val_scores = summaries
    assert list(train_scores) == [f"round_{k}" for k in range(1, 6)]
    assert list(val_scores) == ["val_seen", "val_unseen"]
    for scores in (*train_scores.values(), *val_scores.values()):
        assert all(np.isfinite(scores[mk]) for mk in t_trainer.METRIC_KEYS)
