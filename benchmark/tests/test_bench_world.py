"""The inputs a seed makes: the same for the same seed, other ones for
another seed, and sizes that do not depend on the seed."""
import numpy as np
import torch

from benchmark.lib import harness as H
from benchmark.lib import world as W
from benchmark.reference import params as RP

WORLD = {"scans": 5, "panoramas": 160, "train_scans": 3, "val_unseen_scans": 2}
DATA = {"paths": 20, "instructions_per_path": 3, "min_hops": 4, "max_hops": 6, "rounds": 5,
        "lengths": {"mean_words": 29, "log_sd": 0.35, "min_words": 8, "max_words": 78}}
REQ = {"requests": 16, "joins": 2, "min_words": 38, "max_words": 78, "lengths": DATA["lengths"]}
VOCAB = W.read_vocab(H.BENCH / "configs" / "train_vocab.txt")


def inputs(seed):
    g = W.make_graphs(WORLD, seed)
    s = W.split_scans(g, WORLD)
    return g, W.make_paths(g, s["train"], DATA, VOCAB, seed), W.make_requests(g, s["val_unseen"],
                                                                             REQ, VOCAB, seed)


def same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def test_same_seed_same_inputs():
    assert same(inputs(2 ** 31 + 5), inputs(2 ** 31 + 5))
    f1 = H.make_features(20, 36, 8, 7, "cpu", torch.bfloat16)
    assert torch.equal(f1, H.make_features(20, 36, 8, 7, "cpu", torch.bfloat16))
    w = {"word_emb": 4, "hidden": 8, "feature": 6, "angle": 4, "action_emb": 2}
    p1 = RP.make_params(RP.envdrop_layout(w, 10), 3, "cpu")
    p2 = RP.make_params(RP.envdrop_layout(w, 10), 3, "cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(leaves(p1), leaves(p2)))


def leaves(tree, path=""):
    from benchmark.reference.envdrop import leaves as L

    return L(tree, path)


def test_other_seed_other_inputs_same_sizes():
    (g1, p1, r1), (g2, p2, r2) = inputs(11), inputs(12)
    assert not same(p1, p2)
    assert sorted(len(g["node_ids"]) for g in g1.values()) == \
        sorted(len(g["node_ids"]) for g in g2.values())
    assert sum(len(g["node_ids"]) for g in g1.values()) == WORLD["panoramas"]

    def lengths(paths):
        return sorted(len(t.split()) for p in paths for t in p["instructions"])

    assert lengths(p1) == lengths(p2)
    assert sorted(len(r["instruction"].split()) for r in r1) == \
        sorted(len(r["instruction"].split()) for r in r2)


def test_paths_are_shortest_and_requests_long():
    g, paths, reqs = inputs(3)
    for p in paths:
        assert DATA["min_hops"] <= len(p["path"]) - 1 <= DATA["max_hops"]
        assert 1 <= p["round"] <= DATA["rounds"]
    assert all(38 <= len(r["instruction"].split()) <= 78 for r in reqs)
    assert all(w in VOCAB for r in reqs for w in r["instruction"].split())
