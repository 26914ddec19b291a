"""Tensor parallelism of the port's ViLBERT scorer
(parallel/vilbert_sharding.py) against the JAX package's sharding.

* ``vilbert_param_specs`` covers the port's tree leaf for leaf with the
  JAX package's PartitionSpecs (column-parallel q / k / v, inter, the
  bi-attention q1 ... v2, v_inter / t_inter; row-parallel attn_out, out,
  dense1 / 2, v_out / t_out; the rest replicated);
* ``shard_vilbert_params``: each rank's slices put back together are the
  whole leaf;
* ``score_paths`` over (data 1, model 2) on 2 spawned CPU ranks (gloo)
  equals replicated scoring within 1e-5 (f32), on every rank; the ranks
  load no JAX; training under tensor parallelism is refused;
* the entry point: ``score_difficulty`` over (data 2, model 2) on 4 ranks
  equals one process's scores, and ``build_clr2r`` in 2 processes
  (``--mesh-model 2``) writes the round files one process writes.
"""
import json
import os
import socket
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
import torch_dp_workers as W

from curriculum_learning_for_vln_torch.agents.vln_bert import VLNBertScorer
from curriculum_learning_for_vln_torch.engine.pretrain import score_difficulty
from curriculum_learning_for_vln_torch.models import vilbert as TV
from curriculum_learning_for_vln_torch.parallel import vilbert_sharding as TS
from curriculum_learning_for_vln_torch.utils.tree import tree_leaves
from curriculum_learning_for_vln_tpu.models import vilbert as JV
from curriculum_learning_for_vln_tpu.parallel import vilbert_sharding as JS

torch.set_num_threads(2)

SMALL = dict(vocab_size=80, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, max_position_embeddings=32, v_feature_size=48,
             v_target_size=16, v_hidden_size=32, v_num_hidden_layers=2,
             v_num_attention_heads=4, v_intermediate_size=64, bi_hidden_size=32,
             bi_num_attention_heads=4, v_biattention_id=(0, 1), t_biattention_id=(0, 1))


def _params():
    # weights 15x the default spread, so the logits are O(1) and 1e-5 is tight
    cfg = TV.VilBertConfig(**SMALL, initializer_range=0.3)
    return cfg, TV.vlnbert_init(torch.Generator().manual_seed(0), cfg)


def test_specs_cover_the_tree_as_jax_does():
    cfg, params = _params()
    specs = TS.vilbert_param_specs(params)
    got = [s.axes for s in tree_leaves(specs)]
    assert len(got) == len(tree_leaves(params))
    j_params = JV.vlnbert_init(jax.random.PRNGKey(0), JV.VilBertConfig(**SMALL))
    j_specs = JS.vilbert_param_specs(j_params)
    want = [tuple(s) for s in jax.tree_util.tree_leaves(
        j_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    assert got == want
    assert sum("model" in a for a in got) > 0


def test_rank_slices_make_the_whole_leaf():
    cfg, params = _params()
    ranks = [TS.shard_vilbert_params(params, types.SimpleNamespace(model=2, model_index=r))
             for r in range(2)]
    for leaf, spec, a, b in zip(tree_leaves(params), tree_leaves(TS.vilbert_param_specs(params)),
                                tree_leaves(ranks[0]), tree_leaves(ranks[1])):
        if "model" in spec.axes:
            dim = spec.axes.index("model")
            assert a.shape[dim] * 2 == leaf.shape[dim]
            assert torch.equal(torch.cat([a, b], dim=dim), leaf)
        else:
            assert a is leaf and b is leaf


def test_tp_scoring_matches_replicated():
    cfg, params = _params()
    gen = torch.Generator().manual_seed(1)
    B, Lt, Lv = 6, 12, 5
    txt = torch.randint(1, cfg.vocab_size, (B, Lt), generator=gen)
    imgs = torch.randn(B, Lv, cfg.v_feature_size, generator=gen)
    loc = torch.rand(B, Lv, 12, generator=gen)
    loc[..., 11] = torch.arange(Lv).float()
    tmask = (torch.arange(Lt)[None] < torch.tensor([12, 9, 5, 12, 3, 7])[:, None]).float()
    vmask = (torch.arange(Lv)[None] < torch.tensor([5, 5, 2, 4, 1, 3])[:, None]).float()
    inputs = (txt, imgs, loc, tmask, vmask)
    want = VLNBertScorer(cfg).score_paths(params, *inputs)
    got = W.spawn("tp", 2, {"cfg": cfg, "params": params, "inputs": inputs})
    assert not any(r["jax_loaded"] for r in got)
    q = params["bert"]["t_layers"][0]["attn"]["query"]["w"]
    for r in got:
        assert r["q_shape"] == (q.shape[0], q.shape[1] // 2)  # really sharded
        np.testing.assert_allclose(r["logit"].numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert float(want.std()) > 0.1


def test_difficulty_scores_over_a_data_model_mesh_match_one_process():
    """score_difficulty over (data 2, model 2) on 4 ranks: batches of 7
    padded to 8 (``pad_batch_to_devices``), their rows split over data,
    the heads over model; every rank's scores equal one process's."""
    scorer, params, world, data, tok, feat = W.scoring_inputs()
    want = score_difficulty(scorer, params, world, data, tok, max_path_len=6, feat_dim=feat,
                            batch_size=7)
    got = W.spawn("score", 4, {"model": 2, "batch": 7})
    assert len(want) == len(data) and len(data) % 8 and float(want.std()) > 0.1
    for r in got:
        assert r["mesh"] == (2, 2) and not r["jax_loaded"]
        np.testing.assert_allclose(r["scores"], want, rtol=0, atol=1e-5)


def test_build_clr2r_in_two_processes_matches_one(tmp_path):
    """The build_clr2r entry point in 2 processes (the VLN_* variables,
    --mesh-model 2: the scorer's heads over both) writes the round files
    one process writes, and prints its last line."""
    def run(out, envs, extra):
        cmd = [sys.executable, "-m", "curriculum_learning_for_vln_torch.build_clr2r",
               "--device", "cpu", "--out", str(out), "--steps", "4", *extra]
        procs = [subprocess.Popen(cmd, cwd=W.REPO, env=dict(os.environ, OMP_NUM_THREADS="1", **e),
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for e in envs]
        outs = [p.communicate(timeout=300) for p in procs]
        assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
        return outs[0][0].splitlines()[-1]

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    want = run(tmp_path / "one", [{}], [])
    got = run(tmp_path / "two", [{"VLN_COORDINATOR": f"127.0.0.1:{port}", "VLN_NUM_PROCESSES": "2",
                                  "VLN_PROCESS_ID": str(r)} for r in range(2)],
              ["--mesh-model", "2"])
    assert got == want and json.loads(got)["rounds"]["round_1"] > 0
    for k in range(1, 6):
        name = f"R2R_round_{k}_v3.json"
        assert (tmp_path / "two" / name).read_text() == (tmp_path / "one" / name).read_text()


def test_tp_refuses_training():
    cfg, params = _params()
    tp = types.SimpleNamespace(size=2)
    with pytest.raises(ValueError, match="tensor-parallel"):
        TV.vilbert_apply(params["bert"], cfg, torch.zeros(2, 4, dtype=torch.long),
                         torch.zeros(2, 3, cfg.v_feature_size), torch.zeros(2, 3, 12),
                         train=True, tp=tp)
