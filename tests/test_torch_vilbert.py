"""The port's ViLBERT scorer against the JAX package's: ``vilbert_apply``
and ``vlnbert_apply`` on one small config (hidden 64, 2 text + 2 vision
layers, 4 heads, bi 64, a co-attention layer at each of two ids), the
JAX parameters carried across with ``convert.py`` (tree kind VILBERT) and
the same numpy inputs (padded text and regions).

* f32: every output within 1e-5 x max(1, |ref|) (the same f32 products
  summed in another order), for sum and mul fusion, first and mean
  pooling, with and without a co-attention mask.
* bf16 (the parameters, image features and locations cast to bf16 on
  both sides): within 2e-2 x max(1, |ref|).  Both round every product
  and LayerNorm output to bf16 (2^-8 relative) and both softmaxes are
  f32; XLA's and torch's bf16 GELU and accumulation order differ, so an
  output may land a bf16 ulp or two apart (7e-3 of the scale at worst
  over these cases, one ulp being up to 2^-7 of it).
* The attention mask suppresses padding; ``convert_torch_state_dict``
  lays a reference state dict over the tree as JAX's does; the config's
  JSON round trip; ``path_scorer_inputs`` exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch import convert
from curriculum_learning_for_vln_torch.agents import vln_bert as t_vb
from curriculum_learning_for_vln_torch.models import vilbert as tv
from curriculum_learning_for_vln_torch.utils import tree as t_tree
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents import vln_bert as j_vb
from curriculum_learning_for_vln_tpu.models import vilbert as jv

torch.set_num_threads(2)
B, LT, LV = 3, 12, 7
F32_TOL, BF16_TOL = 1e-5, 2e-2


def small_cfg(module, **kw):
    return module.VilBertConfig(
        vocab_size=50, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=96, max_position_embeddings=24, v_feature_size=40, v_target_size=9,
        v_hidden_size=48, v_num_hidden_layers=2, v_num_attention_heads=4,
        v_intermediate_size=80, bi_hidden_size=64, bi_num_attention_heads=4,
        v_biattention_id=(0, 1), t_biattention_id=(0, 1), **kw)


@pytest.fixture(scope="module")
def setup():
    cfg = small_cfg(jv)
    j_params = jv.vlnbert_init(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree_util.tree_map(np.asarray, j_params)
    assert convert.tree_kind(np_params) == "VILBERT"
    t_params = convert.params_from_jax(np_params)
    rng = np.random.default_rng(0)
    lens = np.array([LT, 7, 4])
    txt = rng.integers(4, cfg.vocab_size, (B, LT))
    txt[np.arange(LT)[None, :] >= lens[:, None]] = 0
    tmask = (txt != 0).astype(np.float32)
    vlens = np.array([LV, 5, 2])
    imask = (np.arange(LV)[None, :] < vlens[:, None]).astype(np.float32)
    imgs = rng.standard_normal((B, LV, cfg.v_feature_size)).astype(np.float32)
    locs = rng.standard_normal((B, LV, 12)).astype(np.float32)
    locs[..., 11] = np.minimum(np.arange(LV), 31)[None, :]
    co = (rng.random((B, LV, LT)) < 0.5).astype(np.float32)
    return cfg, j_params, t_params, dict(txt=txt, tmask=tmask, imask=imask, imgs=imgs,
                                         locs=locs, co=co)


def _close(got, want, tol, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert err <= bound, f"{what}: |port - jax| {err:.3g} > {bound:.3g}"


def _run_both(setup, dtype, co_mask, **cfg_kw):
    cfg, j_params, t_params, x = setup
    j_cfg = dataclasses.replace(cfg, **cfg_kw)
    t_cfg = tv.VilBertConfig.from_dict(j_cfg.to_dict())
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = jax.tree_util.tree_map(lambda a: a.astype(jdt), j_params)
    tp = t_tree.tree_map(lambda a: a.to(tdt), t_params)
    co_j = jnp.asarray(x["co"]) if co_mask else None
    co_t = torch.from_numpy(x["co"]) if co_mask else None
    j_out = jv.vlnbert_apply(jp, j_cfg, jnp.asarray(x["txt"], jnp.int32),
                             jnp.asarray(x["imgs"]).astype(jdt),
                             jnp.asarray(x["locs"]).astype(jdt),
                             attention_mask=jnp.asarray(x["tmask"]),
                             image_attention_mask=jnp.asarray(x["imask"]),
                             co_attention_mask=co_j)
    j_seq = jv.vilbert_apply(jp["bert"], j_cfg, jnp.asarray(x["txt"], jnp.int32),
                             jnp.asarray(x["imgs"]).astype(jdt),
                             jnp.asarray(x["locs"]).astype(jdt),
                             attention_mask=jnp.asarray(x["tmask"]),
                             image_attention_mask=jnp.asarray(x["imask"]),
                             co_attention_mask=co_j)
    t_in = (torch.from_numpy(x["txt"]), torch.from_numpy(x["imgs"]).to(tdt),
            torch.from_numpy(x["locs"]).to(tdt))
    kw = dict(attention_mask=torch.from_numpy(x["tmask"]),
              image_attention_mask=torch.from_numpy(x["imask"]), co_attention_mask=co_t)
    t_out = tv.vlnbert_apply(tp, t_cfg, *t_in, **kw)
    t_seq = tv.vilbert_apply(tp["bert"], t_cfg, *t_in, **kw)
    return j_out, t_out, j_seq, t_seq


@pytest.mark.parametrize("co_mask", [False, True])
@pytest.mark.parametrize("pool", ["first", "mean"])
@pytest.mark.parametrize("fusion", ["sum", "mul"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vlnbert_apply_matches_jax(setup, dtype, fusion, pool, co_mask):
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    j_out, t_out, j_seq, t_seq = _run_both(setup, dtype, co_mask, fusion_method=fusion,
                                           pool_method=pool)
    for name, g, w in zip(("vil_logit", "vision_pred", "linguistic_pred", "seq_relationship"),
                          t_out, j_out):
        _close(g, w, tol, name)
    for name, g, w in zip(("seq_t", "seq_v", "pooled_t", "pooled_v"), t_seq, j_seq):
        _close(g, w, tol, name)
    if dtype == "bf16":  # the activations stay bf16 under bf16 parameters and inputs
        assert t_seq[0].dtype == t_seq[1].dtype == t_out[2].dtype == torch.bfloat16
        assert j_seq[0].dtype == j_seq[1].dtype == j_out[2].dtype == jnp.bfloat16


def test_score_paths_matches_jax(setup):
    cfg, j_params, t_params, x = setup
    j_s = j_vb.VLNBertScorer(cfg).score_paths(
        j_params, jnp.asarray(x["txt"], jnp.int32), jnp.asarray(x["imgs"]),
        jnp.asarray(x["locs"]), jnp.asarray(x["tmask"]), jnp.asarray(x["imask"]))
    t_s = t_vb.VLNBertScorer(tv.VilBertConfig.from_dict(cfg.to_dict())).score_paths(
        t_params, torch.from_numpy(x["txt"]), torch.from_numpy(x["imgs"]),
        torch.from_numpy(x["locs"]), torch.from_numpy(x["tmask"]), torch.from_numpy(x["imask"]))
    assert t_s.shape == (B,)
    _close(t_s, j_s, F32_TOL, "score_paths")


@pytest.mark.parametrize("pool", ["first", "mean"])
def test_attention_mask_suppresses_padding(setup, pool):
    cfg, _, t_params, x = setup
    t_cfg = dataclasses.replace(tv.VilBertConfig.from_dict(cfg.to_dict()), pool_method=pool)
    txt, imgs, locs = (torch.from_numpy(x[k]) for k in ("txt", "imgs", "locs"))
    kw = dict(attention_mask=torch.from_numpy(x["tmask"]),
              image_attention_mask=torch.from_numpy(x["imask"]))
    out1 = tv.vilbert_apply(t_params["bert"], t_cfg, txt, imgs, locs, **kw)
    txt2, imgs2 = txt.clone(), imgs.clone()
    txt2[2, 9] = 42          # a padded token of row 2
    if pool == "mean":
        imgs2[2, 5] = 7.0    # a padded region of row 2
    out2 = tv.vilbert_apply(t_params["bert"], t_cfg, txt2, imgs2, locs, **kw)
    for a, b in zip(out1[2:], out2[2:]):
        assert torch.allclose(a, b, atol=1e-5)


def test_convert_torch_state_dict_matches_jax(setup):
    cfg, j_params, t_params, _ = setup
    rng = np.random.default_rng(1)
    H, V = cfg.hidden_size, cfg.vocab_size

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"bert.embeddings.word_embeddings.weight": r(V, H),
          "bert.embeddings.LayerNorm.gamma": r(H),
          "bert.t_pooler.dense.weight": r(cfg.bi_hidden_size, H),
          "bert.t_pooler.dense.bias": r(cfg.bi_hidden_size),
          "bert.encoder.layer.1.attention.self.query.weight": r(H, H),
          "bert.encoder.layer.0.output.LayerNorm.beta": r(H),
          "bert.encoder.v_layer.1.intermediate.dense.weight":
              r(cfg.v_intermediate_size, cfg.v_hidden_size),
          "bert.encoder.c_layer.0.biattention.query1.weight":
              r(cfg.bi_hidden_size, cfg.v_hidden_size),
          "bert.encoder.c_layer.1.biOutput.LayerNorm2.weight": r(H),
          "bert.v_embeddings.image_sequence_embeddings.weight": r(32, cfg.v_hidden_size),
          "cls.predictions.bias": r(V),
          "cls.imagePredictions.decoder.weight": r(cfg.v_target_size, cfg.v_hidden_size),
          "vil_logit.weight": r(1, cfg.bi_hidden_size),
          "some.unknown.tensor": r(3)}
    want = jax.tree_util.tree_map(np.asarray, jv.convert_torch_state_dict(sd, cfg, j_params))
    got = tv.convert_torch_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                      tv.VilBertConfig.from_dict(cfg.to_dict()), t_params)
    leaves_w, leaves_g = jax.tree_util.tree_leaves(want), t_tree.tree_leaves(got)
    assert len(leaves_w) == len(leaves_g)
    for g, w in zip(leaves_g, leaves_w):
        np.testing.assert_array_equal(g.numpy(), w)
    # untouched leaves keep their values, and the input tree is left as it was
    assert torch.equal(got["bert"]["v_pooler"]["w"], t_params["bert"]["v_pooler"]["w"])
    word = got["bert"]["embeddings"]["word"]
    assert not torch.equal(word, t_params["bert"]["embeddings"]["word"])
    back = convert.params_to_jax(got)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(back), leaves_w))


def test_config_json_roundtrip(tmp_path):
    cfg = small_cfg(tv, fusion_method="sum", pool_method="mean")
    d = cfg.to_dict()
    assert d["v_biattention_id"] == list(cfg.v_biattention_id)
    assert tv.VilBertConfig.from_dict({**d, "unknown_hf_key": 123}) == cfg
    p = tmp_path / "config.json"
    p.write_text(cfg.to_json_string())
    assert tv.VilBertConfig.from_json_file(str(p)) == cfg
    # the same JSON as the JAX package's config
    assert cfg.to_json_string() == small_cfg(jv, fusion_method="sum",
                                             pool_method="mean").to_json_string()


def test_vlnbert_init_has_the_jax_tree():
    cfg = small_cfg(tv)
    t_params = tv.vlnbert_init(torch.Generator().manual_seed(0), cfg)
    j_params = jv.vlnbert_init(jax.random.PRNGKey(0), small_cfg(jv))
    t_leaves, j_leaves = t_tree.tree_leaves(t_params), jax.tree_util.tree_leaves(j_params)
    assert [tuple(t.shape) for t in t_leaves] == [tuple(a.shape) for a in j_leaves]
    assert convert.tree_kind(convert.params_to_jax(t_params)) == "VILBERT"


def test_path_scorer_inputs_exact(synth_world, synth_graphs):
    w = synth_world
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    t_world.features = w.features.copy()
    scan = w.scan_ids[0]
    g1 = int(w.cand_next[0, 0])
    nodes = [0, g1, int(w.cand_next[g1, 1]), g1, 0]
    views = [int(w.cand_view[0, 0]), 5, 30, 13, 12]
    for L in (8, 3):
        want = j_vb.path_scorer_inputs(w, scan, nodes, views, max_path_len=L, feat_dim=64)
        got = t_vb.path_scorer_inputs(t_world, scan, nodes, views, max_path_len=L, feat_dim=64)
        for g, a in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, a)
