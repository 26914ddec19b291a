"""The port's ViLBERT pretraining and CLR2R construction against the JAX
package's (engine/pretrain.py), on the JAX test's tiny grounded world
(2 scans x 24 nodes, 64-d features, 24 paths x 3 instructions) and a
small config (hidden 32, 2 + 2 layers, 4 heads, bi 32):

* ``mask_lm_tokens`` / ``mask_regions``: their distribution and validity
  (the draws are torch's, so only the distribution can match);
* the pretraining loss, its four terms and every gradient leaf, given the
  masks JAX drew, at train=False: within 1e-4 x max(1, |ref|);
* one Adam step (``ClippedAdam`` without a clip against ``optax.adam``,
  two updates from the same gradients): within 1e-6;
* the loss falls over the JAX test's 8 epochs of training;
* ``pretrain_batches``, ``views_along_path`` and ``make_clr2r_rounds``
  exactly; ``score_difficulty`` within 1e-4;
* the cache layer (``models/file_utils.py``) on the cases of the JAX
  package's tests/test_file_utils.py, and ``vlnbert_from_pretrained``;
* ``python -m curriculum_learning_for_vln_torch.build_clr2r --device cpu
  --steps 4`` writes five round files.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from curriculum_learning_for_vln_torch import convert
from curriculum_learning_for_vln_torch.agents.vln_bert import VLNBertScorer as TScorer
from curriculum_learning_for_vln_torch.engine import pretrain as tp
from curriculum_learning_for_vln_torch.engine.loop import ClippedAdam
from curriculum_learning_for_vln_torch.models import file_utils as tf
from curriculum_learning_for_vln_torch.models import vilbert as tv
from curriculum_learning_for_vln_torch.utils import tree as t_tree
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents.vln_bert import VLNBertScorer as JScorer
from curriculum_learning_for_vln_tpu.data.datasets import expand_r2r_items
from curriculum_learning_for_vln_tpu.engine import pretrain as jp
from curriculum_learning_for_vln_tpu.models import vilbert as jv
from curriculum_learning_for_vln_tpu.utils.tokenizer import Tokenizer, build_vocab
from curriculum_learning_for_vln_tpu.world import compiler, synthetic

torch.set_num_threads(2)
MAX_PATH, FEAT = 8, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg(module, vocab_size):
    return module.VilBertConfig(
        vocab_size=vocab_size, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=32, v_feature_size=FEAT,
        v_target_size=len(synthetic.ROOM_TYPES), v_hidden_size=32, v_num_hidden_layers=2,
        v_num_attention_heads=4, v_intermediate_size=64, bi_hidden_size=32,
        bi_num_attention_heads=4, v_biattention_id=(0, 1), t_biattention_id=(0, 1))


@pytest.fixture(scope="module")
def grounded():
    graphs = synthetic.make_world_graphs(num_scans=2, nodes_per_scan=24, seed=5)
    world = compiler.compile_world(graphs, max_candidates=16, use_native=False)
    rooms = synthetic.assign_rooms(world, seed=5)
    synthetic.attach_grounded_features(world, rooms, feature_dim=FEAT, seed=5)
    items = synthetic.make_grounded_dataset(graphs, world, rooms, num_paths=24, seed=1)
    tok = Tokenizer(build_vocab(items, min_count=1), encoding_length=24)
    data = expand_r2r_items(items, tok)
    t_world = t_compiler.compile_world(graphs, max_candidates=16, use_native=False)
    t_world.features = world.features.copy()
    return world, t_world, rooms, data, tok


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_mask_lm_tokens_distribution():
    gen = torch.Generator().manual_seed(0)
    tokens = torch.full((64, 32), 10)
    masked, labels = tp.mask_lm_tokens(gen, tokens, vocab_size=50, mask_idx=1, p=0.15)
    sel = labels >= 0
    assert 0.10 < float(sel.float().mean()) < 0.20            # ~15% selected
    m = masked[sel]
    assert 0.7 < float((m == 1).float().mean()) < 0.9         # ~80% -> [MASK]
    assert 0.03 < float(((m != 1) & (m != 10)).float().mean()) < 0.17  # ~10% random words
    assert bool(((m >= tp.N_SPECIAL_TOKENS) | (m == 1)).all())  # never a special token
    assert bool((labels[sel] == 10).all()) and bool((masked[~sel] == 10).all())
    # special tokens are never masked
    _, labels2 = tp.mask_lm_tokens(gen, torch.zeros((64, 32), dtype=torch.long), 50, 1, p=0.5)
    assert bool((labels2 == -1).all())


def test_mask_regions_respects_validity():
    gen = torch.Generator().manual_seed(0)
    feats = torch.ones((16, MAX_PATH, FEAT))
    region_mask = torch.zeros((16, MAX_PATH))
    region_mask[:, :4] = 1.0
    masked, sel = tp.mask_regions(gen, feats, region_mask, p=0.5)
    assert int(sel[:, 4:].sum()) == 0                          # padding never selected
    assert 0.3 < float(sel[:, :4].float().mean()) < 0.7
    assert bool((masked[sel] == 0.0).all()) and bool((masked[~sel] == 1.0).all())


def _one_hot(rooms):
    """The port's region targets of the grounded world: one-hot room types."""
    return torch.eye(len(synthetic.ROOM_TYPES))[torch.from_numpy(rooms)]


def _batch(world, data, tok, rooms):
    """The first pretraining batch of the JAX package, and the same batch
    made by the port."""
    kw = dict(batch_size=8, max_path_len=MAX_PATH, feat_dim=FEAT, region_classes=rooms,
              n_region_classes=len(synthetic.ROOM_TYPES), epochs=1, seed=0)
    return next(iter(jp.pretrain_batches(world, data, tok, **kw))), kw


def test_pretrain_batches_equal_jax(grounded):
    world, t_world, rooms, data, tok = grounded
    kw = dict(batch_size=8, max_path_len=MAX_PATH, feat_dim=FEAT, region_classes=rooms,
              n_region_classes=len(synthetic.ROOM_TYPES), epochs=2, seed=3)
    j_b = list(jp.pretrain_batches(world, data, tok, **kw))
    t_kw = {k: v for k, v in kw.items() if k not in ("region_classes", "n_region_classes")}
    t_b = list(tp.pretrain_batches(t_world, data, tok, device="cpu",
                                   node_targets=_one_hot(rooms), **t_kw))
    assert len(j_b) == len(t_b) == 2 * (len(data) // 8)
    for a, b in zip(j_b, t_b):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]), err_msg=k)


def test_pretrain_loss_and_grads_match_jax_given_its_masks(grounded):
    world, t_world, rooms, data, tok = grounded
    batch, _ = _batch(world, data, tok, rooms)
    cfg = tiny_cfg(jv, tok.vocab_size())
    j_params = jv.vlnbert_init(jax.random.PRNGKey(0), cfg)
    rng = jax.random.PRNGKey(7)
    loss_fn = jp.build_pretrain_loss(cfg, mask_idx=1)
    args = [batch[k] for k in ("tokens", "feats", "locs", "region_mask", "region_targets",
                               "align_labels")]
    (j_loss, j_logs), j_grads = jax.value_and_grad(
        lambda p: loss_fn(p, *args, rng, train=False), has_aux=True)(j_params)
    # the masks JAX drew inside loss_fn (pretrain.py:77-81)
    r_lm, r_rg, _ = jax.random.split(rng, 3)
    masked_tokens, lm_labels = jp.mask_lm_tokens(r_lm, batch["tokens"], cfg.vocab_size, 1)
    masked_feats, region_sel = jp.mask_regions(r_rg, batch["feats"], batch["region_mask"])
    assert int(np.asarray(lm_labels >= 0).sum()) > 0 and int(np.asarray(region_sel).sum()) > 0

    def t(a, dtype=None):
        x = torch.from_numpy(np.array(a))
        return x.long() if dtype == "long" else x

    masks = tp.PretrainMasks(t(masked_tokens, "long"), t(lm_labels, "long"), t(masked_feats),
                             t(region_sel))
    t_params = t_tree.tree_map(lambda x: x.requires_grad_(True),
                               convert.params_from_jax(_np(j_params)))
    t_cfg = tv.VilBertConfig.from_dict(cfg.to_dict())
    t_loss, t_logs = tp.pretrain_loss(
        t_params, t_cfg, t(batch["tokens"], "long"), t(batch["locs"]), t(batch["region_mask"]),
        t(batch["region_targets"]), t(batch["align_labels"], "long"), masks, train=False)
    t_loss.backward()
    for k in j_logs:
        want = float(j_logs[k])
        assert abs(float(t_logs[k].detach()) - want) <= 1e-4 * max(1.0, abs(want)), k
    leaves_t, leaves_j = t_tree.tree_leaves(t_params), jax.tree_util.tree_leaves(j_grads)
    assert len(leaves_t) == len(leaves_j)
    for p, g in zip(leaves_t, leaves_j):
        g = np.asarray(g)
        assert p.grad is not None
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(g).max())))
    # the tied LM decoder's gradient sums its two uses (embedding and decoder)
    assert float(np.abs(np.asarray(j_grads["bert"]["embeddings"]["word"])).max()) > 0


def test_adam_step_matches_optax():
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * s for k, v in p0.items()}
             for s in (1.0, 1e-3)]
    opt = optax.adam(3e-4)
    j_p = jax.tree_util.tree_map(jnp.asarray, p0)
    state = opt.init(j_p)
    params = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in p0.items()}
    t_opt = ClippedAdam(t_tree.tree_leaves(params), 3e-4, max_norm=None)
    for g in grads:
        upd, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g), state, j_p)
        j_p = optax.apply_updates(j_p, upd)
        for k, v in params.items():
            v.grad = torch.from_numpy(g[k] * 1e3)  # far past any clip: none applies
        t_opt.zero_grad(set_to_none=False)
        for k, v in params.items():
            v.grad = torch.from_numpy(g[k].copy())
        t_opt.step()
    for k in p0:
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(j_p[k]), rtol=0,
                                   atol=1e-6)


def test_pretrainer_loss_decreases(grounded):
    world, t_world, rooms, data, tok = grounded
    trainer = tp.VLNBertPretrainer(tiny_cfg(tv, tok.vocab_size()), mask_idx=1, lr=3e-4)
    params, opt = trainer.init(torch.Generator().manual_seed(0))

    def batches(epochs):
        return tp.pretrain_batches(t_world, data, tok, batch_size=8, max_path_len=MAX_PATH,
                                   feat_dim=FEAT, node_targets=_one_hot(rooms), epochs=epochs,
                                   seed=0, device="cpu")

    gen = torch.Generator().manual_seed(1)
    params, opt, logs0 = trainer.train(params, opt, list(batches(1))[:2], gen, log_every=0)
    first = float(logs0["loss"])
    params, opt, logs = trainer.train(params, opt, batches(8), gen, log_every=0)
    last = float(logs["loss"])
    assert np.isfinite(first) and np.isfinite(last)
    assert last < first, (first, last)


def test_views_along_path_exact(grounded):
    world, t_world, rooms, data, tok = grounded
    for item in data[::7]:
        nodes = [world.global_id(item["scan"], vp) for vp in item["path"]]
        assert tp.views_along_path(t_world, nodes) == jp.views_along_path(world, nodes)
    assert tp.views_along_path(t_world, [3]) == jp.views_along_path(world, [3]) == [12]


def test_score_difficulty_and_rounds_match_jax(grounded):
    world, t_world, rooms, data, tok = grounded
    cfg = tiny_cfg(jv, tok.vocab_size())
    j_scorer = JScorer(cfg)
    j_params, _ = j_scorer.init(jax.random.PRNGKey(3))
    j_scores = jp.score_difficulty(j_scorer, j_params, world, data, tok, max_path_len=MAX_PATH,
                                   feat_dim=FEAT, batch_size=8)
    t_params = convert.params_from_jax(_np(j_params))
    t_scores = tp.score_difficulty(TScorer(tv.VilBertConfig.from_dict(cfg.to_dict())), t_params,
                                   t_world, data, tok, max_path_len=MAX_PATH, feat_dim=FEAT,
                                   batch_size=8)
    assert t_scores.shape == (len(data),) and t_scores.dtype == np.float32
    np.testing.assert_allclose(t_scores, j_scores, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(j_scores).max())))
    for n_rounds in (5, 3):
        want = jp.make_clr2r_rounds(data, j_scores, n_rounds=n_rounds)
        got = tp.make_clr2r_rounds(data, j_scores, n_rounds=n_rounds)
        assert list(got) == list(want)
        for k in want:
            assert [it["instr_id"] for it in got[k]] == [it["instr_id"] for it in want[k]]
    rounds = tp.make_clr2r_rounds(data, t_scores, n_rounds=5)
    assert sum(len(v) for v in rounds.values()) == len(data)
    by_id = {it["instr_id"]: s for it, s in zip(data, t_scores)}
    assert (min(by_id[it["instr_id"]] for it in rounds["round_1"])
            >= max(by_id[it["instr_id"]] for it in rounds["round_5"]))


# -- the cache layer: the cases of the JAX package's tests/test_file_utils.py

def test_url_to_filename_etag_changes_name():
    a = tf.url_to_filename("https://x/y.bin")
    b = tf.url_to_filename("https://x/y.bin", etag='"abc"')
    assert a != b and a == tf.url_to_filename("https://x/y.bin")
    assert len(a) == 64 and len(b) == 129


def test_local_path_passthrough(tmp_path):
    p = tmp_path / "w.npz"
    p.write_bytes(b"123")
    assert tf.cached_path(str(p)) == str(p)
    with pytest.raises(FileNotFoundError):
        tf.cached_path(str(tmp_path / "missing.bin"))


def test_file_url_caches_and_roundtrips_metadata(tmp_path):
    src = tmp_path / "ckpt.bin"
    src.write_bytes(b"checkpoint-bytes")
    cache = tmp_path / "cache"
    url = src.as_uri()
    out = tf.cached_path(url, cache_dir=str(cache))
    assert os.path.dirname(out) == str(cache)
    assert open(out, "rb").read() == b"checkpoint-bytes"
    got_url, etag = tf.filename_to_url(os.path.basename(out), cache_dir=str(cache))
    assert got_url == url and etag
    n_before = len(os.listdir(cache))
    assert tf.cached_path(url, cache_dir=str(cache)) == out  # a cache hit
    assert len(os.listdir(cache)) == n_before
    src.write_bytes(b"different")  # new content, new etag, new entry
    out2 = tf.cached_path(url, cache_dir=str(cache))
    assert out2 != out and open(out2, "rb").read() == b"different"


def test_split_s3_path_and_helpers(tmp_path):
    assert tf.split_s3_path("s3://bucket/a/b.bin") == ("bucket", "a/b.bin")
    with pytest.raises(ValueError):
        tf.split_s3_path("s3://bucketonly")
    f = tmp_path / "set.txt"
    f.write_text("alpha\nbeta\n")
    assert tf.read_set_from_file(str(f)) == {"alpha", "beta"}
    assert tf.get_file_extension("A/B.BIN") == ".bin"
    assert tf.get_file_extension("a/b.bin", dot=False) == "bin"


@pytest.mark.parametrize("fmt", ["torch", "npz"])
def test_vlnbert_from_pretrained_roundtrip(tmp_path, fmt):
    """cached_path, the state_dict load and the conversion in one call (the
    reference's from_pretrained, vilbert.py:1049-1254)."""
    cfg = tv.VilBertConfig(
        vocab_size=32, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=32, max_position_embeddings=16, v_feature_size=16, v_target_size=4,
        v_hidden_size=16, v_num_hidden_layers=1, v_num_attention_heads=2,
        v_intermediate_size=32, bi_hidden_size=16, bi_num_attention_heads=2,
        v_biattention_id=(0,), t_biattention_id=(0,))
    word = np.random.default_rng(0).standard_normal((32, 16)).astype(np.float32)
    key = "bert.embeddings.word_embeddings.weight"
    if fmt == "torch":
        ckpt = tmp_path / "model.bin"
        torch.save({key: torch.from_numpy(word)}, str(ckpt))
    else:
        ckpt = tmp_path / "model.npz"  # read as arrays by its extension: a local path
        np.savez(str(ckpt), **{key: word})
    where = ckpt.as_uri() if fmt == "torch" else str(ckpt)
    params = tv.vlnbert_from_pretrained(where, cfg, torch.Generator().manual_seed(1),
                                        cache_dir=str(tmp_path / "cache"))
    assert np.allclose(params["bert"]["embeddings"]["word"].numpy(), word)


def test_build_clr2r_writes_five_rounds(tmp_path):
    out = tmp_path / "clr2r"
    run = subprocess.run([sys.executable, "-m", "curriculum_learning_for_vln_torch.build_clr2r",
                          "--out", str(out), "--device", "cpu", "--steps", "4"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    last = json.loads(run.stdout.strip().splitlines()[-1])
    assert list(last["rounds"]) == [f"round_{k}" for k in range(1, 6)]
    assert np.isfinite(last["final_loss"])
    n = 0
    for k in range(1, 6):
        with open(out / f"R2R_round_{k}_v3.json") as f:
            items = json.load(f)
        assert len(items) == last["rounds"][f"round_{k}"]
        assert all({"scan", "path", "instructions", "path_id"} <= set(it) for it in items)
        n += len(items)
    assert n == 120  # every path of the default --paths, each in one round
