"""The port's speaker decoding and back-translation against the JAX
package, from the same parameters, on the small synthetic world of
``test_torch_speaker.py`` (F = 192, RNN_DIM 64, MAX_DECODE 20, T = 8).

* greedy ``infer``: every step's logits (<UNK> banned), teacher-forced on
  the JAX words, within 1e-4 up to each sample's <EOS>, and the words
  equal; where a near-tie (the JAX logits' two best within 1e-4) flips a
  word, the test says so and compares that sample no further, as
  ``compare_actions`` in chip_smoke.py does;
* sampled ``infer`` with the JAX Gumbel draw replayed (the keys ``infer``
  splits, ``jax.random.gumbel`` of the logits' shape, which is how
  ``jax.random.categorical`` draws): the words equal, the log-
  probabilities within 1e-5;
* the encoder through a shared noise mask, in f32 and in bf16 (the mask
  cast to the compute dtype first: bf16 features stay bf16), at the
  tolerances of ``test_torch_speaker.py``; ``back_translate`` with JAX's
  mask replayed: the injected batch equal field by field;
* ``valid``: the instructions of every path, the teacher-forcing loss
  (1e-4) and the word and sentence accuracies.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.agents import speaker as t_spk
from curriculum_learning_for_vln_torch.models import speaker_model as t_sm
from curriculum_learning_for_vln_torch.utils import tokenizer as t_tok
from curriculum_learning_for_vln_tpu.agents import speaker as j_spk
from curriculum_learning_for_vln_tpu.models import speaker_model as j_sm
from curriculum_learning_for_vln_tpu.models.attention import NEG_INF
from curriculum_learning_for_vln_tpu.utils.tokenizer import BOS_IDX, EOS_IDX, UNK_IDX
from test_torch_speaker import (ATOL, B, EP_LEN, FEAT_DIM, PREC, close, make_setup, speakers,
                                t_feats, t_params, tables)

torch.set_num_threads(2)

MAX_DECODE = 20


@pytest.fixture(scope="module")
def setup(synth_world, synth_graphs, synth_dataset, tokenizer):
    s = make_setup(synth_world, synth_graphs, synth_dataset, tokenizer, seed=11)
    jt, _ = tables(s, "f32")
    s["j_ep"] = s["j_env"].next_batch()
    s["t_ep"] = s["t_env"].next_batch()
    s["fj"] = j_spk.collect_shortest_path_features(jt, s["j_ep"], EP_LEN)
    return s


def _step_logits(s, j_speaker, t_speaker, words_j):
    """Each decoding step's logits (<UNK> banned) in both packages, the
    decoder fed BOS then the JAX words: a greedy decode's inputs up to each
    sample's end."""
    inputs = np.concatenate([np.full((B, 1), BOS_IDX), words_j[:, :-1]], axis=1)
    ctx_j, mask_j = j_speaker._encode(s["j_params"], s["fj"], jax.random.PRNGKey(0), False)
    h0 = jnp.zeros((B, 64))
    lj, _, _ = j_sm.speaker_decoder_apply(s["j_params"]["decoder"], jnp.asarray(inputs), ctx_j,
                                          mask_j, h0, h0, jax.random.PRNGKey(0), False)
    tp = t_params(s["j_params"])
    with torch.no_grad():
        ctx_t, mask_t = t_speaker._encode(tp, t_feats(s["fj"]), False)
        lt, _, _ = t_sm.speaker_decoder_apply(tp["decoder"], torch.from_numpy(inputs).long(),
                                              ctx_t, mask_t, torch.zeros(B, 64),
                                              torch.zeros(B, 64), False)
    lj = np.asarray(lj, np.float32).copy()
    lj[..., UNK_IDX] = NEG_INF
    lt = lt.numpy().copy()
    lt[..., UNK_IDX] = NEG_INF
    return lj, lt


def test_greedy_infer_matches_jax(setup):
    s = setup
    j_speaker, t_speaker = speakers(s["V"])
    words_j, lp_j = j_speaker.infer(s["j_params"], s["fj"], jax.random.PRNGKey(5))
    words_j = np.asarray(words_j)
    with torch.no_grad():
        words_t, lp_t = t_speaker.infer(t_params(s["j_params"]), t_feats(s["fj"]))
    assert tuple(words_t.shape) == (B, MAX_DECODE) and not lp_t.any()
    assert not (words_t == UNK_IDX).any()
    lj, lt = _step_logits(s, j_speaker, t_speaker, words_j)
    # a step is live until the word before it was <EOS>
    live = np.cumsum(np.concatenate([np.zeros((B, 1)), words_j[:, :-1] == EOS_IDX], 1), 1) == 0
    np.testing.assert_allclose(lt[live], lj[live], rtol=0, atol=ATOL)
    top2 = np.sort(lj, axis=-1)[..., -2:]
    ties = 0
    for b in range(B):
        for t in np.flatnonzero(live[b]):
            if words_t[b, t] != words_j[b, t]:
                gap = top2[b, t, 1] - top2[b, t, 0]
                assert gap <= ATOL, f"sample {b} step {t}: words differ without a tie ({gap})"
                print(f"sample {b}: a near-tie at step {t} (gap {gap:.2g}) flips the word")
                ties += 1
                break
        else:
            np.testing.assert_array_equal(words_t[b].numpy(), words_j[b])
    assert ties < B


def test_sampled_infer_replays_jax_gumbel(setup, monkeypatch):
    s = setup
    j_speaker, t_speaker = speakers(s["V"])
    rng = jax.random.PRNGKey(6)
    words_j, lp_j = j_speaker.infer(s["j_params"], s["fj"], rng, sampling=True)
    # infer's keys: (rng, rng_e) = split(rng); split(rng, MAX_DECODE); each (rng_d, rng_s)
    step_keys = [jax.random.split(k)[1] for k in jax.random.split(jax.random.split(rng)[0],
                                                                   MAX_DECODE)]
    probe = jax.random.normal(jax.random.PRNGKey(9), (B, s["V"]))
    np.testing.assert_array_equal(  # categorical is argmax(logits + gumbel of its shape)
        np.asarray(jax.random.categorical(step_keys[0], probe)),
        np.asarray(jnp.argmax(probe + jax.random.gumbel(step_keys[0], probe.shape), -1)))
    noise = iter([torch.from_numpy(np.array(jax.random.gumbel(k, (B, s["V"]), jnp.float32)))
                  for k in step_keys])
    monkeypatch.setattr(t_spk, "gumbel_noise", lambda shape, generator, device: next(noise))
    with torch.no_grad():
        words_t, lp_t = t_speaker.infer(t_params(s["j_params"]), t_feats(s["fj"]), sampling=True)
    np.testing.assert_array_equal(words_t.numpy(), np.asarray(words_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=0, atol=1e-5)
    assert (lp_t < 0).any()


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_masked_encoder_matches_jax(setup, prec, monkeypatch):
    s = setup
    dt, jdt = PREC[prec]
    j_speaker, t_speaker = speakers(s["V"], prec, FEAT_DROPOUT=0.3)
    jt, _ = tables(s, prec)
    fj = j_spk.collect_shortest_path_features(jt, s["j_ep"], EP_LEN, jdt)
    mask = j_speaker.make_drop_mask(jax.random.PRNGKey(8), FEAT_DIM)
    assert mask.dtype == jnp.float32 and 0 < float((mask == 0).mean()) < 1
    ctx_j, cm_j = j_speaker._encode(s["j_params"], fj, jax.random.PRNGKey(0), False,
                                    feat_mask=mask)
    seen = []
    encode = t_sm.speaker_encoder_apply

    def spy(p, can, img, *args, **kwargs):
        seen.append((can.dtype, img.dtype))
        return encode(p, can, img, *args, **kwargs)

    monkeypatch.setattr(t_spk, "speaker_encoder_apply", spy)
    with torch.no_grad():
        ctx_t, cm_t = t_speaker._encode(t_params(s["j_params"]), t_feats(fj), False,
                                        feat_mask=torch.from_numpy(np.asarray(mask)))
    assert seen == [(dt, dt)]  # the masked features in the compute dtype
    np.testing.assert_array_equal(cm_t.numpy(), np.asarray(cm_j))
    tol = 1e-5 if prec == "f32" else 3e-2
    close(ctx_t, ctx_j, tol * max(1.0, float(jnp.abs(ctx_j).max())))


def test_back_translate_matches_jax(setup, monkeypatch):
    s = setup
    j_speaker, t_speaker = speakers(s["V"], FEAT_DROPOUT=0.3)
    jt, tt = tables(s, "f32")
    rng = jax.random.PRNGKey(12)
    noise_j = j_speaker.make_drop_mask(jax.random.split(rng)[0], FEAT_DIM)
    monkeypatch.setattr(t_speaker, "make_drop_mask",
                        lambda generator, feat_dim, device=None:
                        torch.from_numpy(np.asarray(noise_j)))
    new_j, mask_j = j_speaker.back_translate(s["j_params"], jt, s["j_env"], s["j_ep"], 24, rng,
                                             FEAT_DIM)
    new_t, mask_t = t_speaker.back_translate(t_params(s["j_params"]), tt, s["t_env"], s["t_ep"],
                                             24, None, FEAT_DIM)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    for name in new_t._fields:
        np.testing.assert_array_equal(getattr(new_t, name).numpy(),
                                      np.asarray(getattr(new_j, name)), err_msg=name)
    toks, lens = new_t.instr_tokens.numpy(), new_t.instr_len.numpy()
    assert (toks[:, 0] == BOS_IDX).all() and (toks[np.arange(B), lens - 1] == EOS_IDX).all()
    np.testing.assert_array_equal(new_t.start_node.numpy(), s["t_ep"].start_node.numpy())


def test_valid_matches_jax(setup, tokenizer):
    s = setup
    j_speaker, t_speaker = speakers(s["V"])
    jt, tt = tables(s, "f32")
    tok = t_tok.Tokenizer(tokenizer.vocab, encoding_length=tokenizer.encoding_length)
    p2i_j, loss_j, word_j, sent_j = j_speaker.valid(s["j_params"], jt, s["j_env"],
                                                    jax.random.PRNGKey(5), tokenizer=tokenizer,
                                                    n_batches=2)
    p2i_t, loss_t, word_t, sent_t = t_speaker.valid(t_params(s["j_params"]), tt, s["t_env"],
                                                    tokenizer=tok, n_batches=2)
    assert p2i_t == p2i_j and len(p2i_t) == len({it["path_id"] for it in s["data"]})
    assert abs(loss_t - loss_j) <= ATOL and loss_t > 0
    assert (word_t, sent_t) == (word_j, sent_j)
