"""ViLBERT at its published configuration (vilbert_beta's
``config/bert_base_6layer_6conect.json``) on the port's pretraining path,
at a small size on the CPU with a head count of its own in each stream
(text 4, image 2, co-attention 3):

* the published JSON loads to exactly its widths, the parameter count
  matches a closed form, and values the port does not compute raise;
* the word lookup through ``F.embedding``: its gradient equals the index
  route's within f32 rounding on mostly-padding batches, and the forward
  is bit for bit the index route's in bf16 and f32;
* ``pretrain_batches``' card-side gather yields the numpy route's batches,
  in order, from an f32 or a bf16 table, with soft region targets;
* the port against the benchmark's plain reference
  (``benchmark/reference/vilbert.py``) on seeded weights: the logits, the
  loss and every gradient leaf, with dropout off and with the keep-masks
  the port drew;
* ``benchmark/lib/vilbert_costs.py`` against ``FlopCounterMode``;
* the spans under a profiler (and no ``record_function`` without one),
  the backward's work put under its forward's span
  (``benchmark/lib/program_spans.py``), the pretrainer's counters;
* ``build_clr2r --vilbert-config`` on a small published-form JSON.
"""
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from benchmark.lib import program_spans, vilbert_costs
from benchmark.reference import vilbert as RV
from benchmark.runners.vilbert_pretrain import DrawSpy
from curriculum_learning_for_vln_torch import build_clr2r
from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
from curriculum_learning_for_vln_torch.engine import pretrain as tp
from curriculum_learning_for_vln_torch.models import vilbert as tv
from curriculum_learning_for_vln_torch.utils.tokenizer import Tokenizer, build_vocab
from curriculum_learning_for_vln_torch.utils.tree import tree_leaves, tree_map
from curriculum_learning_for_vln_torch.world import compiler, synthetic

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUBLISHED = os.path.join(REPO, "configs", "vilbert", "bert_base_6layer_6conect.json")
B, LT, R, MASK_ID = 6, 12, 5, 3


def small() -> dict:
    """The published file's keys at small widths, each stream its own heads."""
    with open(PUBLISHED) as f:
        c = json.load(f)
    c.update(vocab_size=40, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
             intermediate_size=48, max_position_embeddings=16, v_feature_size=24,
             v_target_size=10, v_hidden_size=40, v_num_hidden_layers=2, v_num_attention_heads=2,
             v_intermediate_size=40, bi_hidden_size=24, bi_num_attention_heads=3,
             bi_intermediate_size=24, v_biattention_id=[0, 1], t_biattention_id=[2, 3])
    return c


def batch(seed: int = 0) -> dict:
    """A batch of B pairs: instructions of 3-12 tokens padded with 0, paths
    of 2-5 steps."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(3, LT + 1, (B,), generator=g)
    tokens = torch.randint(4, 40, (B, LT), generator=g)
    tokens = torch.where(torch.arange(LT)[None] < lengths[:, None], tokens, 0)
    steps = torch.randint(2, R + 1, (B,), generator=g)
    region_mask = (torch.arange(R)[None] < steps[:, None]).float()
    locs = torch.randn((B, R, 12), generator=g)
    locs[..., 11] = torch.arange(R).float()
    return {"tokens": tokens, "feats": torch.rand((B, R, 24), generator=g) * region_mask[..., None],
            "locs": locs * region_mask[..., None], "region_mask": region_mask,
            "region_targets": torch.softmax(torch.randn((B, R, 10), generator=g), -1),
            "align_labels": torch.randint(0, 2, (B,), generator=g)}


def trainable(cfg, seed: int = 0, dtype=torch.float32) -> dict:
    return tree_map(lambda t: t.to(dtype).requires_grad_(True),
                    tv.vlnbert_init(torch.Generator().manual_seed(seed), cfg))


# ---------------------------------------------------------------------------
# the published file
# ---------------------------------------------------------------------------

def test_published_json_loads_to_its_widths():
    cfg = tv.VilBertConfig.from_json_file(PUBLISHED)
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.intermediate_size, cfg.max_position_embeddings, cfg.type_vocab_size) == (
        30522, 768, 12, 12, 3072, 512, 2)
    assert (cfg.v_feature_size, cfg.v_target_size, cfg.v_hidden_size, cfg.v_num_hidden_layers,
            cfg.v_num_attention_heads, cfg.v_intermediate_size) == (2048, 1601, 1024, 6, 8, 1024)
    assert (cfg.bi_hidden_size, cfg.bi_num_attention_heads) == (1024, 8)
    assert cfg.v_biattention_id == (0, 1, 2, 3, 4, 5)
    assert cfg.t_biattention_id == (6, 7, 8, 9, 10, 11)
    assert cfg.fusion_method == "mul" and cfg.pool_method == "first"
    assert cfg.hidden_dropout_prob == cfg.attention_probs_dropout_prob == 0.1
    assert cfg.v_hidden_dropout_prob == cfg.v_attention_probs_dropout_prob == 0.1


def closed_form_count(c: dict) -> int:
    D, Ft, V, P, T = (c["hidden_size"], c["intermediate_size"], c["vocab_size"],
                      c["max_position_embeddings"], c["type_vocab_size"])
    Dv, Fv, Bi, F, K = (c["v_hidden_size"], c["v_intermediate_size"], c["bi_hidden_size"],
                        c["v_feature_size"], c["v_target_size"])

    def lin(i, o):
        return i * o + o

    def layer(d, f):
        return 4 * lin(d, d) + lin(d, f) + lin(f, d) + 4 * d

    text = (V + P + T) * D + 2 * D + c["num_hidden_layers"] * layer(D, Ft)
    image = (lin(F, Dv) + lin(5, Dv) + lin(4, Dv) + lin(2, Dv) + 32 * Dv + 2 * Dv
             + c["v_num_hidden_layers"] * layer(Dv, Fv))
    co = (3 * lin(Dv, Bi) + 3 * lin(D, Bi) + lin(Bi, Dv) + lin(Bi, D) + lin(Dv, Fv) + lin(Fv, Dv)
          + lin(D, Ft) + lin(Ft, D) + 4 * Dv + 4 * D)
    heads = (lin(D, Bi) + lin(Dv, Bi) + lin(D, D) + 2 * D + V + lin(Bi, 2) + lin(Dv, Dv)
             + 2 * Dv + lin(Dv, K) + lin(Bi, 1))
    return text + image + len(c["v_biattention_id"]) * co + heads


def test_parameter_count_is_the_closed_form():
    with open(PUBLISHED) as f:
        c = json.load(f)
    with torch.device("meta"):
        params = tv.vlnbert_init(torch.Generator(), tv.VilBertConfig.from_dict(c))
    n = sum(t.numel() for t in tree_leaves(params))
    assert n == closed_form_count(c) == 239_065_214


@pytest.mark.parametrize("key,value", [("hidden_act", "relu"), ("v_hidden_act", "gelu_new"),
                                       ("bi_attention_type", 2), ("pooling_method", "max")])
def test_values_the_port_does_not_compute_raise(key, value):
    with open(PUBLISHED) as f:
        c = json.load(f)
    with pytest.raises(ValueError, match=key):
        tv.VilBertConfig.from_dict({**c, key: value})


def test_pooling_method_is_the_fusion_method():
    c = small()
    assert tv.VilBertConfig.from_dict({**c, "pooling_method": "sum"}).fusion_method == "sum"
    assert tv.VilBertConfig.from_dict({**c, "fusion_method": "mul"}).fusion_method == "mul"
    with pytest.raises(ValueError, match="disagree"):
        tv.VilBertConfig.from_dict({**c, "pooling_method": "sum", "fusion_method": "mul"})


# ---------------------------------------------------------------------------
# the word lookup
# ---------------------------------------------------------------------------

def index_route(ids, weight, *args, **kwargs):
    return weight[ids]


def forward_outputs(params, cfg, b):
    return tv.vlnbert_apply(params, cfg, b["tokens"], b["feats"].to(params["vil_logit"]["w"].dtype),
                            b["locs"], attention_mask=(b["tokens"] != 0).float(),
                            image_attention_mask=b["region_mask"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_is_the_index_routes_bit_for_bit(dtype, monkeypatch):
    cfg = tv.VilBertConfig.from_dict(small())
    params, b = trainable(cfg, dtype=dtype), batch(1)
    new = forward_outputs(params, cfg, b)
    monkeypatch.setattr(torch.nn.functional, "embedding", index_route)
    old = forward_outputs(params, cfg, b)
    for x, y in zip(new, old):
        assert torch.equal(x, y)


def test_word_gradient_is_the_index_routes_on_padding(monkeypatch):
    cfg = tv.VilBertConfig.from_dict(small())
    params, b = trainable(cfg), batch(2)
    b["tokens"][:, 2:] = 0  # nearly every position the padding id

    def word_grad():
        vil, region, lm, align = forward_outputs(params, cfg, b)
        loss = vil.sum() + region.square().mean() + lm.square().mean() + align.sum()
        return torch.autograd.grad(loss, params["bert"]["embeddings"]["word"])[0]

    new = word_grad()
    monkeypatch.setattr(torch.nn.functional, "embedding", index_route)
    old = word_grad()
    # the same f32 sums in another order: a few roundings of the largest row's scale
    assert float((new - old).abs().max()) <= 1e-6 * float(old.abs().max())
    assert float(new[0].abs().max()) > 0  # the padding row takes its gradient, as in JAX


# ---------------------------------------------------------------------------
# the card-side gather
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grounded():
    graphs = synthetic.make_world_graphs(num_scans=2, nodes_per_scan=20, seed=3)
    world = compiler.compile_world(graphs, max_candidates=16, use_native=False)
    rooms = synthetic.assign_rooms(world, seed=3)
    synthetic.attach_grounded_features(world, rooms, feature_dim=24, seed=3)
    items = synthetic.make_grounded_dataset(graphs, world, rooms, num_paths=10, seed=4)
    tok = Tokenizer(build_vocab(items, min_count=1), encoding_length=16)
    return world, rooms, expand_r2r_items(items, tok), tok


def one_hot(rooms):
    return torch.eye(len(synthetic.ROOM_TYPES))[torch.from_numpy(rooms)]


def numpy_route(world, data, features, targets, seed, epochs):
    """The batches as the port made them on the host: every path's features
    copied row by row, the whole batch uploaded."""
    toks, feats, locs, rmask, _ = tp.pretrain_arrays(world, data, None, R, 24)
    a = tp.path_arrays(world, data, R)
    feats = np.where(rmask[..., None] > 0, features[a.nodes, a.views], 0.0).astype(np.float32)
    tgt = np.where(rmask[..., None] > 0, targets[a.nodes],
                   np.float32(1.0 / targets.shape[1])).astype(np.float32)
    rng, n = np.random.default_rng(seed), len(data)
    for _ in range(epochs):
        order = rng.permutation(n)
        for s in range(0, n - 8 + 1, 8):
            idx = order[s: s + 8]
            t = toks[idx].copy()
            labels = np.ones(8, np.int64)
            for j in np.where(rng.random(8) < 0.5)[0]:
                other = int(rng.integers(n - 1))
                t[j] = toks[other + (other >= idx[j])]
                labels[j] = 0
            yield {"tokens": t, "feats": feats[idx], "locs": locs[idx], "region_mask": rmask[idx],
                   "region_targets": tgt[idx], "align_labels": labels}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_gather_yields_the_numpy_routes_batches(grounded, dtype):
    world, rooms, data, tok = grounded
    table = torch.from_numpy(world.features).to(dtype)
    targets = torch.softmax(torch.randn((world.features.shape[0], 7),
                                        generator=torch.Generator().manual_seed(0)), -1)
    got = list(tp.pretrain_batches(world, data, tok, 8, R, 24, epochs=2, seed=5, device="cpu",
                                   features=table, node_targets=targets))
    want = list(numpy_route(world, data, table.float().numpy(), targets.numpy(), 5, 2))
    assert len(got) == len(want) == 2 * (len(data) // 8)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
        np.testing.assert_array_equal(g.text_lengths, (w["tokens"] != 0).sum(1))


# ---------------------------------------------------------------------------
# the port against the plain reference
# ---------------------------------------------------------------------------

def test_logits_match_the_reference():
    c = small()
    cfg = tv.VilBertConfig.from_dict(c)
    params, b = trainable(cfg), batch(3)
    with torch.no_grad():
        vil, region, lm, align = forward_outputs(params, cfg, b)
        r_lm, r_region, r_align, r_vil = RV.forward(
            lambda x: x, params, c, b["tokens"], b["feats"], b["locs"],
            (b["tokens"] != 0).float(), b["region_mask"], None)
    # f32, the same sums in another order through 4 + 2 layers: ~1e-7 of each output's scale
    for x, y in ((lm, r_lm), (region, r_region), (align, r_align), (vil[:, 0], r_vil)):
        assert float((x - y).abs().max()) <= 2e-6 * float(y.abs().max().clamp_min(1.0))


@pytest.mark.parametrize("dropout_on", [False, True])
def test_loss_and_gradients_match_the_reference(dropout_on):
    c = small()
    cfg = tv.VilBertConfig.from_dict(c)
    params, b = trainable(cfg), batch(4)
    gen = torch.Generator().manual_seed(9)
    with DrawSpy() as spy:
        masks = tp.draw_pretrain_masks(gen, b["tokens"], b["feats"], b["region_mask"],
                                       cfg.vocab_size, MASK_ID)
        loss, logs = tp.pretrain_loss(params, cfg, b["tokens"], b["locs"], b["region_mask"],
                                      b["region_targets"], b["align_labels"], masks,
                                      train=dropout_on, generator=gen)
    assert len(spy.draws) == (4 if not dropout_on else 4 + 2 + 3 * 6 + 6 * 2 + 1)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    ref = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    r_logs = RV.loss(lambda x: x, ref, c, b, RV.Draws(spy.draws, "cpu"), MASK_ID, 0.15, 0.15,
                     dropout_on)
    r_grads = torch.autograd.grad(r_logs["loss"], tree_leaves(ref))
    # f32: the loss to a few roundings; each gradient leaf to 1e-5 of its norm, or of the
    # median leaf's where it is 0 but for round-off (the key biases)
    for k in r_logs:
        assert float(logs[k].detach()) == pytest.approx(float(r_logs[k].detach()), rel=1e-6,
                                                        abs=1e-7), k
    floor = 1e-4 * float(np.median([float(g.norm()) for g in r_grads]))
    for g, r in zip(grads, r_grads):
        assert float((g - r).norm()) <= 1e-5 * max(float(r.norm()), floor)


def test_costs_count_what_flop_counter_counts():
    c = small()
    trainer = tp.VLNBertPretrainer(tv.VilBertConfig.from_dict(c), mask_idx=MASK_ID)
    params, opt = trainer.init(torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as counter:
        trainer.step(params, opt, batch(5), torch.Generator().manual_seed(1))
    assert counter.get_total_flops() == vilbert_costs.step_flops(c, B, LT, R)


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

PARENTS = {"vln.iter": None, "vln.pretrain.masks": "vln.iter", "vln.pretrain.loss": "vln.iter",
           "vln.vilbert.embed": "vln.iter", "vln.vilbert.text": "vln.iter",
           "vln.vilbert.vision": "vln.iter", "vln.vilbert.coattn": "vln.iter",
           "vln.vilbert.heads": "vln.iter", "vln.update.backward": "vln.iter",
           "vln.update.optim": "vln.iter", "vln.pretrain.batch": None}


@pytest.fixture(scope="module")
def traced_step(grounded):
    world, rooms, data, tok = grounded
    c = dict(small(), vocab_size=tok.vocab_size(), v_target_size=len(synthetic.ROOM_TYPES))
    trainer = tp.VLNBertPretrainer(tv.VilBertConfig.from_dict(c), mask_idx=1)
    params, opt = trainer.init(torch.Generator().manual_seed(0))
    batches = tp.pretrain_batches(world, data, tok, 8, R, 24, node_targets=one_hot(rooms),
                                  device="cpu")
    gen = torch.Generator().manual_seed(1)
    trainer.step(params, opt, next(batches), gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.step(params, opt, next(batches), gen)
    return prof, c


def test_every_span_appears_in_its_parent(traced_step):
    prof, c = traced_step
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith("vln.")), key=lambda s: s[1])
    counts = Counter(n for n, _, _ in spans)
    assert set(counts) == set(PARENTS)
    assert counts["vln.vilbert.text"] == c["num_hidden_layers"]
    assert counts["vln.vilbert.vision"] == c["v_num_hidden_layers"]
    assert counts["vln.vilbert.coattn"] == len(c["v_biattention_id"])
    assert counts["vln.vilbert.heads"] == 2 and counts["vln.iter"] == 1
    for name, a, b in spans:
        around = [n for n, x, y in spans if x <= a and b <= y and (n, x, y) != (name, a, b)]
        assert (around[-1] if around else None) == PARENTS[name], name


def test_the_backward_counts_under_its_forwards_span(traced_step):
    """Every matrix product a co-attention layer runs, and the two (or one)
    of its backward, land under ``vln.vilbert.coattn``: the products stand
    in for launches on the CPU."""
    prof, c = traced_step
    spans, _l, _d, nodes, forward = program_spans.profile_lists(prof)
    products = [e for e in prof.events() if e.name in ("aten::mm", "aten::bmm")]
    launches = {e.id: e.time_range.start / 1e6 for e in products}
    by_span = program_spans.attribute(spans, launches, [(i, 1.0) for i in launches], nodes,
                                      forward)
    coattn = [(a, b) for n, a, b in spans if n == "vln.vilbert.coattn"]
    fwd = sum(any(a <= e.time_range.start / 1e6 < b for a, b in coattn) for e in products
              if e.sequence_nr >= 0)
    # a layer: 6 query / key / value maps, 2 outputs, 4 FFN maps, 2 x 2 attention products
    assert fwd == 16 * len(c["v_biattention_id"])
    # and two products of the backward each: every input of every product needs its gradient
    assert by_span["vln.vilbert.coattn"] == 3 * fwd


def test_attribute_puts_launches_by_their_node_or_their_call():
    """Hand-made lists: a forward op (thread 1, sequence 7) under
    ``vln.vilbert.coattn``; its backward node runs later under
    ``vln.update.backward``; a launch inside the node counts with the
    forward, one after it with the backward's span, one with no call found
    outside every span."""
    spans = [("vln.iter", 0.0, 10.0), ("vln.vilbert.coattn", 1.0, 2.0),
             ("vln.update.backward", 5.0, 8.0)]
    nodes = [(5.5, 6.0, (1, 7)), (6.5, 7.0, (1, 99))]  # the second's forward is not in the trace
    forward = {(1, 7): 1.5}
    launches = {1: 5.7, 2: 6.2, 3: 6.7, 4: 9.5}
    got = program_spans.attribute(spans, launches, [(1, 1.0), (2, 2.0), (3, 4.0), (4, 8.0),
                                                    (5, 16.0)], nodes, forward)
    assert got == {"vln.vilbert.coattn": 1.0, "vln.update.backward": 6.0, "vln.iter": 8.0,
                   program_spans.OUTSIDE: 16.0}


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a record_function was built with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    c = small()
    trainer = tp.VLNBertPretrainer(tv.VilBertConfig.from_dict(c), mask_idx=MASK_ID)
    params, opt = trainer.init(torch.Generator().manual_seed(0))
    trainer.step(params, opt, batch(6), torch.Generator().manual_seed(1))


def test_counters_count_from_the_hosts_lengths(grounded, monkeypatch):
    world, rooms, data, tok = grounded
    c = dict(small(), vocab_size=tok.vocab_size(), v_target_size=len(synthetic.ROOM_TYPES))
    trainer = tp.VLNBertPretrainer(tv.VilBertConfig.from_dict(c), mask_idx=1)
    params, opt = trainer.init(torch.Generator().manual_seed(0))
    drawn, draw = [], tp.draw_pretrain_masks
    monkeypatch.setattr(tp, "draw_pretrain_masks", lambda *a, **k: drawn.append(draw(*a, **k))
                        or drawn[-1])
    batches = list(tp.pretrain_batches(world, data, tok, 8, R, 24, node_targets=one_hot(rooms),
                                       device="cpu"))[:2]
    gen = torch.Generator().manual_seed(1)
    for b in batches:
        trainer.step(params, opt, b, gen)
    got = trainer.counters
    assert (got.steps, got.pairs, got.text_positions) == (2, 16, 2 * 8 * 16)
    assert got.pad_positions == sum(int((b["tokens"] == 0).sum()) for b in batches)
    assert got.masked() == (sum(int((m.lm_labels >= 0).sum()) for m in drawn),
                            sum(int(m.region_sel.sum()) for m in drawn))
    plain = tp.PretrainCounters()
    plain.add(dict(batches[0]), drawn[0])  # a plain dict: no host lengths to count from
    assert (plain.pairs, plain.text_positions, plain.pad_positions) == (8, 0, 0)


def test_build_clr2r_takes_a_published_form_config(tmp_path):
    c = dict(small(), vocab_size=200, max_position_embeddings=32, v_feature_size=32,
             v_target_size=len(synthetic.ROOM_TYPES))
    path = tmp_path / "vilbert.json"
    path.write_text(json.dumps(c))
    out = build_clr2r.main(["--out", str(tmp_path / "rounds"), "--device", "cpu", "--steps", "2",
                            "--batch-size", "8", "--scans", "2", "--nodes", "16", "--paths", "12",
                            "--vilbert-config", str(path)])
    assert sum(out["rounds"].values()) == 12 and np.isfinite(out["final_loss"])
    assert sorted(os.listdir(tmp_path / "rounds")) == [f"R2R_round_{k}_v3.json"
                                                       for k in range(1, 6)]
