"""The port's speaker against the JAX package, from the same parameters
(``params_from_jax`` of a JAX ``Speaker.init``), on B = 4 episodes of a
small synthetic world (64-d features and the 128 angle dims: F = 192), at
narrow widths (RNN_DIM 64, WEMB 32, MAX_DECODE 20, T = 8).

* ``collect_shortest_path_features``: lengths equal, features within 1e-6
  (in f32 and bf16);
* ``speaker_encoder_apply`` and ``speaker_decoder_apply`` at train=False,
  the decoder resumed from a random (h0, c0): within 1e-5 in f32; in bf16
  within 3e-2 x max(1, max |JAX|), the tolerance of the port's other bf16
  decoder tests (the frameworks round bf16 products at other places, and a
  bf16 ulp is 2^-8);
* ``teacher_forcing_loss`` (and its per-word matrix) and its gradient,
  every leaf, against ``jax.value_and_grad`` with both dropout rates at 0:
  within 1e-4 (an 8-step BiLSTM and a 24-token decoder of f32 products
  whose sums run in another order);
* ``generated_to_instr_tokens`` on the JAX test's edge cases and equal to
  JAX's on random words; ``R2RBatchEnv.inject_batch`` against JAX's;
* ``convert``: the speaker tree kind, and a speaker checkpoint written by
  the port read back with its optimizer state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch import convert
from curriculum_learning_for_vln_torch.agents import speaker as t_spk
from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv as TEnv
from curriculum_learning_for_vln_torch.models import speaker_model as t_sm
from curriculum_learning_for_vln_torch.utils import config as t_config
from curriculum_learning_for_vln_torch.utils import tree as t_tree
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents import speaker as j_spk
from curriculum_learning_for_vln_tpu.agents.common import cast_compute_params
from curriculum_learning_for_vln_tpu.data.datasets import expand_r2r_items
from curriculum_learning_for_vln_tpu.env.host_env import R2RBatchEnv as JEnv
from curriculum_learning_for_vln_tpu.models import speaker_model as j_sm
from curriculum_learning_for_vln_tpu.utils import config as j_config
from curriculum_learning_for_vln_tpu.utils.tokenizer import BOS_IDX, EOS_IDX, PAD_IDX

torch.set_num_threads(2)

FEAT_DIM, EP_LEN, B = 64, 8, 4
ATOL = 1e-4
PREC = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def spk_cfg(config, **kw):
    """The speaker config at the test's widths, dropout off unless given."""
    s = config.get_cfg_defaults().AIDE.SPEAKER
    s.RNN_DIM, s.WEMB, s.MAX_DECODE, s.LR, s.BI_DIRECTION = 64, 32, 20, 1e-3, True
    s.DROPOUT = s.FEAT_DROPOUT = 0.0
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def speakers(vocab_size, prec="f32", **kw):
    dt, jdt = PREC[prec]
    return (j_spk.Speaker(spk_cfg(j_config, **kw), vocab_size, feat_dim=FEAT_DIM,
                          episode_len=EP_LEN, compute_dtype=jdt),
            t_spk.Speaker(spk_cfg(t_config, **kw), vocab_size, feat_dim=FEAT_DIM,
                          episode_len=EP_LEN, compute_dtype=dt))


def make_setup(synth_world, synth_graphs, synth_dataset, tokenizer, seed=9):
    """Both packages' worlds and episode sources over the same items, the
    JAX speaker parameters and their conversion."""
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    t_world.features = synth_world.features.copy()
    data = expand_r2r_items(synth_dataset, tokenizer)
    j_speaker, _ = speakers(tokenizer.vocab_size())
    j_params, _ = j_speaker.init(jax.random.PRNGKey(0))
    return {"j_world": synth_world, "t_world": t_world, "data": data, "tok": tokenizer,
            "j_env": JEnv(synth_world, data, batch_size=B, tokenizer=tokenizer, seed=seed),
            "t_env": TEnv(t_world, data, B, tokenizer, seed=seed, device="cpu"),
            "j_params": j_params, "V": tokenizer.vocab_size()}


def t_params(j_params, grad=False):
    p = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    return t_tree.tree_map(lambda t: t.requires_grad_(grad), p)


def tables(s, prec):
    return s["j_world"].device_tables(prec), s["t_world"].device_tables(prec, device="cpu")


def t_feats(feats_j):
    f = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32)))
    return t_spk.SpeakerFeatures(f(feats_j.img_feats), f(feats_j.can_feats),
                                 torch.from_numpy(np.array(feats_j.lengths)).long())


def close(got, want, atol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(want, jnp.float32)), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def setup(synth_world, synth_graphs, synth_dataset, tokenizer):
    return make_setup(synth_world, synth_graphs, synth_dataset, tokenizer)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_collect_shortest_path_features_match_jax(setup, prec):
    s = setup
    dt, jdt = PREC[prec]
    jt, tt = tables(s, prec)
    j_ep, t_ep = s["j_env"].next_batch(), s["t_env"].next_batch()
    np.testing.assert_array_equal(t_ep.item_idx.numpy(), np.asarray(j_ep.item_idx))
    fj = j_spk.collect_shortest_path_features(jt, j_ep, EP_LEN, jdt)
    ft = t_spk.collect_shortest_path_features(tt, t_ep, EP_LEN, dt)
    assert ft.img_feats.dtype == ft.can_feats.dtype == dt
    assert tuple(ft.img_feats.shape) == (B, EP_LEN, 36, FEAT_DIM + 128)
    np.testing.assert_array_equal(ft.lengths.numpy(), np.asarray(fj.lengths))
    assert (ft.lengths >= 1).all() and (ft.lengths < EP_LEN).any()  # some walk stops early
    close(ft.img_feats, fj.img_feats, 1e-6)
    close(ft.can_feats, fj.can_feats, 1e-6)
    for b, n in enumerate(ft.lengths.tolist()):  # zero from the stop step on
        assert not ft.can_feats[b, n - 1:].any()


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_encoder_and_decoder_match_jax(setup, prec):
    s = setup
    dt, jdt = PREC[prec]
    jt, _ = tables(s, prec)
    j_ep = s["j_env"].next_batch()
    fj = j_spk.collect_shortest_path_features(jt, j_ep, EP_LEN, jdt)
    ft = t_feats(fj)
    jp = cast_compute_params(s["j_params"], jdt)
    tp = t_spk.cast_compute_params(t_params(s["j_params"]), dt)
    ctx_j = j_sm.speaker_encoder_apply(jp["encoder"], fj.can_feats, fj.img_feats,
                                       jax.random.PRNGKey(0), False)
    ctx_t = t_sm.speaker_encoder_apply(tp["encoder"], ft.can_feats.to(dt), ft.img_feats.to(dt),
                                       False)
    assert ctx_t.dtype == torch.float32 and tuple(ctx_t.shape) == (B, EP_LEN, 64)
    tol = 1e-5 if prec == "f32" else 3e-2
    close(ctx_t, ctx_j, tol * max(1.0, float(jnp.abs(ctx_j).max())))

    rng = np.random.default_rng(1)
    h0, c0 = (rng.standard_normal((B, 64)).astype(np.float32) * 0.5 for _ in range(2))
    ctx_mask = np.arange(EP_LEN)[None, :] >= np.asarray(fj.lengths)[:, None]
    words = np.asarray(j_ep.instr_tokens)
    lj, hj, cj = j_sm.speaker_decoder_apply(jp["decoder"], jnp.asarray(words), ctx_j,
                                            jnp.asarray(ctx_mask), jnp.asarray(h0),
                                            jnp.asarray(c0), jax.random.PRNGKey(1), False)
    lt, ht, ct = t_sm.speaker_decoder_apply(tp["decoder"], torch.from_numpy(words).long(),
                                            torch.from_numpy(np.asarray(ctx_j, np.float32)),
                                            torch.from_numpy(ctx_mask), torch.from_numpy(h0),
                                            torch.from_numpy(c0), False)
    assert tuple(lt.shape) == (B, words.shape[1], s["V"])
    for got, want in ((lt, lj), (ht, hj), (ct, cj)):
        close(got, want, tol * max(1.0, float(jnp.abs(want).max())))


def test_teacher_forcing_loss_and_grads_match_jax(setup):
    s = setup
    j_speaker, t_speaker = speakers(s["V"])
    jt, _ = tables(s, "f32")
    j_ep = s["j_env"].next_batch()
    fj = j_spk.collect_shortest_path_features(jt, j_ep, EP_LEN)
    insts = j_ep.instr_tokens

    loss_j, grads_j = jax.value_and_grad(
        lambda p: j_speaker.teacher_forcing_loss(p, fj, insts, jax.random.PRNGKey(2),
                                                 train=True))(s["j_params"])
    tp = t_params(s["j_params"], grad=True)
    ti = torch.from_numpy(np.asarray(insts)).long()
    loss_t = t_speaker.teacher_forcing_loss(tp, t_feats(fj), ti, True)
    loss_t.backward()
    close(loss_t, loss_j, ATOL)
    leaves_t, leaves_j = t_tree.tree_leaves(tp), jax.tree_util.tree_leaves(grads_j)
    assert len(leaves_t) == len(leaves_j)
    for p, gj in zip(leaves_t, leaves_j):  # baseline_fc* are unused: no gradient, JAX's 0
        close(torch.zeros_like(p) if p.grad is None else p.grad, gj, ATOL)
    per_word_j = j_speaker.teacher_forcing_loss(s["j_params"], fj, insts, jax.random.PRNGKey(2),
                                                train=False, for_listener=True)
    with torch.no_grad():
        per_word_t = t_speaker.teacher_forcing_loss(tp, t_feats(fj), ti, False, for_listener=True)
    close(per_word_t, per_word_j, ATOL)
    assert not per_word_t[ti[:, 1:] == PAD_IDX].any()


def test_generated_to_instr_tokens_matches_jax():
    words = np.array([
        [5, 6, EOS_IDX, 9, 9],       # EOS mid-sequence: truncate after EOS
        [5, 6, 7, 8, 9],             # no EOS: forced terminal EOS
        [PAD_IDX, 0, 0, 0, 0],       # empty: BOS + EOS
    ])
    tokens, lengths = t_spk.generated_to_instr_tokens(words, enc_len=6)
    assert tokens[0, :4].tolist() == [BOS_IDX, 5, 6, EOS_IDX] and lengths[0] == 4
    assert tokens[1].tolist()[:6] == [BOS_IDX, 5, 6, 7, 8, EOS_IDX] and lengths[1] == 6
    assert tokens[2, :2].tolist() == [BOS_IDX, EOS_IDX] and lengths[2] == 2
    rng = np.random.default_rng(3)
    for enc_len in (3, 6, 12):
        w = rng.integers(0, 8, (16, 10))
        for got, want in zip(t_spk.generated_to_instr_tokens(w, enc_len),
                             j_spk.generated_to_instr_tokens(w, enc_len)):
            np.testing.assert_array_equal(got, want)


def test_inject_batch_matches_jax(setup):
    s = setup
    j_ep, t_ep = s["j_env"].next_batch(), s["t_env"].next_batch()
    idx = np.asarray(j_ep.item_idx)[::-1].copy()
    tokens, lengths = t_spk.generated_to_instr_tokens(
        np.random.default_rng(4).integers(4, 9, (B, 7)), enc_len=10)
    nj = s["j_env"].inject_batch(idx, tokens, lengths)
    nt = s["t_env"].inject_batch(idx, tokens, lengths)
    for name in t_ep._fields:
        np.testing.assert_array_equal(getattr(nt, name).numpy(), np.asarray(getattr(nj, name)),
                                      err_msg=name)
    assert nt.valid.all() and (s["t_env"].cur_batch_index == idx).all()


def test_convert_and_checkpoint_with_optimizer_state(setup, tmp_path):
    s = setup
    assert convert.tree_kind(jax.tree_util.tree_map(np.asarray, s["j_params"])) == "SPEAKER"
    _, t_speaker = speakers(s["V"])
    params, opt = t_speaker.prepare(t_params(s["j_params"]))
    back = convert.params_to_jax(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(s["j_params"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    _, tt = tables(s, "f32")
    gen = torch.Generator().manual_seed(0)
    params, opt, losses = t_speaker.train_steps(params, opt, tt, s["t_env"], gen, 2)
    assert len(losses) == 2 and all(np.isfinite(losses))
    path = str(tmp_path / "speaker.ckpt")
    t_speaker.save(path, params, opt, epoch=3)
    p2, opt2, epoch = t_speaker.load(path, load_optim=True)
    assert epoch == 3
    for a, b in zip(t_tree.tree_leaves(params), t_tree.tree_leaves(p2)):
        assert torch.equal(a.detach(), b.detach()) and b.requires_grad
    st, st2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    assert len(st) == len(t_tree.tree_leaves(params)) and st.keys() == st2.keys()
    for k in st:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k][name], st2[k][name]), (k, name)
    # the same next update from the restored state
    for p, q in zip(t_tree.tree_leaves(params), t_tree.tree_leaves(p2)):
        p.grad = torch.ones_like(p)
        q.grad = torch.ones_like(q)
    opt.step()
    opt2.step()
    for a, b in zip(t_tree.tree_leaves(params), t_tree.tree_leaves(p2)):
        assert torch.equal(a.detach(), b.detach())
    fresh = t_speaker.load(path)[1]
    assert not fresh.state_dict()["state"]
