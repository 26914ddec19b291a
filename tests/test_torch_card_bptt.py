"""The rollout BPTT (``TPU.FUSED_BPTT``, ``ops/bptt.py``) and the native
shortest-path solver on the card, on the serving world at EnvDrop's full
width, B = 64, T = 35, prng.

* One classic iteration with ``TPU.FUSED_BPTT`` on (the hand-written
  rollout backward) against off, in bf16 and f32, from the same
  parameters, batch and generator seed: the losses within 1e-5 relative,
  every gradient leaf within 1e-4 in L2 (f32) or 1e-2 (bf16), the
  generator's state equal, the launches exact (on: K1 = K2 = 4, K4 = K6 =
  1 for the A2C tail's bootstrap step, nothing else).
* The peak device memory of one bf16 iteration at B = 64, in prng and
  ext: lower with the flag on than off (the BPTT draws its masks again and
  gathers the observations again where autograd stores them).  Run with
  ``-s`` to see both peaks.
* ``main`` with ``TPU.FUSED_BPTT True`` (PACKED_RL 0) for one short epoch
  on the 6 x 160 synthetic world (K5 = K7 = 0).
* The native C++ solver builds, and the serve world compiled with it has
  scipy's tables but its distances (within 1e-4) and its next hops at
  equal-cost ties (each still on a shortest path).
"""
import gc
import math

import numpy as np
import pytest
import torch
from torch_card_world import (BATCH, CONFIG, FEAT_DIM, NODES_PER_SCAN, NUM_SCANS, SEED,  # noqa
                              card, finish_main, iteration_launches, launch_counts, launches_of,
                              leaf_paths, reset_launch_counts, serving, start_main)

MAIN_ITERS = 2  # iterations of the ``main`` run


def bptt_launches(t_il, T, on):
    """A classic iteration's launches with TPU.FUSED_BPTT ``on``: the
    encoder's K1 = K2 = 4 and, inside the BPTT rollouts, no observation
    kernel; the A2C tail's bootstrap step alone runs K4 and K6 once."""
    if on:
        return launches_of(lstm_scan_train=4, lstm_scan_bwd=4, pano_attend=1, cand_score=1)
    return iteration_launches(t_il, T)


def setup(serving, device, prec, batch_size, seed):
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.utils import tree
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    world, data, _, tok, cfg, m, params0 = serving
    agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), FEAT_DIM,
                         cfg.AGENT.MAX_EPISODE_LEN, compute_dtype=PRECISIONS[prec],
                         obs_masks="prng")
    env = R2RBatchEnv(world, expand_r2r_items(data, tok), batch_size, tok, seed=seed,
                      device=device)
    batch = env.next_batch()
    params = tree.tree_map(lambda t: t.to(device).requires_grad_(True), params0)
    return agent, world.device_tables(prec, device), params, batch, il_bucket_fn(cfg, agent)(env)


@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_bptt_iteration_equals_the_fused_one(serving, card, prec):
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.utils import tree

    agent, tables, params, batch, il_len = setup(serving, card, prec, BATCH, SEED + 3)
    T = agent.episode_len
    leaves = tree.tree_leaves(params)
    runs = {}
    for on in (False, True):
        agent.use_fused_bptt = on
        gen = torch.Generator(device=card).manual_seed(SEED + 7)
        for p in leaves:
            p.grad = None
        reset_launch_counts()
        total, _ = loop.iteration_loss(agent, "sample", tables, params, batch, gen, il_len=il_len)
        total.backward()
        runs[on] = (total.item(), launch_counts(), gen.get_state(),
                    [p.grad.detach().clone() for p in leaves])
        want = bptt_launches(il_len or T, T, on)
        assert runs[on][1] == want, f"{prec} FUSED_BPTT {on}: launches {runs[on][1]}, " \
                                    f"expected {want} (T_il {il_len or T})"
    (l0, _, s0, g0), (l1, _, s1, g1) = runs[False], runs[True]
    assert torch.equal(s0, s1), f"{prec}: the generator ends elsewhere with the BPTT"
    assert abs(l1 - l0) / max(abs(l0), 1e-6) <= 1e-5, f"{prec}: loss BPTT {l1} vs fused {l0}"
    tol = 1e-4 if prec == "f32" else 1e-2
    for path, a, b in zip(leaf_paths(params), g0, g1, strict=True):
        rel = float((b - a).float().norm()) / max(float(a.float().norm()), 1e-12)
        assert rel <= tol, f"{prec}: gradient {'.'.join(map(str, path))} BPTT vs fused " \
                           f"{rel:.3g} in L2 > {tol}"


@pytest.mark.parametrize("mode", ["prng", "ext"])
def test_bptt_peak_memory_is_below_the_fused_path(serving, card, mode):
    """The peak device memory through one bf16 iteration (its loss, then its
    backward) above what was allocated before it, at B = 64: the BPTT's
    below autograd's; the losses and gradients finite."""
    from curriculum_learning_for_vln_torch.engine import loop
    from curriculum_learning_for_vln_torch.utils import tree

    agent, tables, params, batch, il_len = setup(serving, card, "bf16", BATCH, SEED + 5)
    agent.obs_masks = mode
    leaves = tree.tree_leaves(params)
    peak = {}
    for on in (False, True):
        agent.use_fused_bptt = on
        for p in leaves:
            p.grad = None
        gen = torch.Generator(device=card).manual_seed(SEED + 7)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        total, logs = loop.iteration_loss(agent, "sample", tables, params, batch, gen,
                                          il_len=il_len)
        total.backward()
        torch.cuda.synchronize()
        peak[on] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        assert math.isfinite(total.item()) and all(bool(torch.isfinite(p.grad).all())
                                                   for p in leaves), \
            f"memory B {BATCH} {mode} FUSED_BPTT {on}: finite loss and gradients"
        del total, logs
    print(f"peak MiB through one bf16 iteration at B = {BATCH}, {mode}: FUSED_BPTT off "
          f"{peak[False]:.1f}, on {peak[True]:.1f}")
    assert peak[True] < peak[False], \
        f"{mode}: the BPTT's peak {peak[True]:.1f} MiB is not below autograd's {peak[False]:.1f}"


def test_main_with_fused_bptt(card, tmp_path):
    args = ["--config-file", CONFIG, "TPU.FUSED_BPTT", "True", "TPU.PACKED_RL", 0,
            "TRAIN.MAX_EPOCH", 1, "TRAIN.ITER_PER_EPOCH", MAIN_ITERS, "TRAIN.EVAL_INTERVAL", 1]
    counts, lines, _ = finish_main("bptt", start_main(args, str(tmp_path)), str(tmp_path))
    assert "Using Classic trainer" in lines and sum("Epoch [" in ln for ln in lines) == 1, \
        f"main bptt: log {lines}"
    assert counts["lstm_scan_train"] == counts["lstm_scan_bwd"] == 4 * MAIN_ITERS \
        and counts["pano_attend_bwd"] == counts["cand_score_bwd"] == 0 \
        and counts["pano_attend"] >= MAIN_ITERS and counts["lstm_scan"] > 0, \
        f"main bptt: launches {counts}"


def test_native_solver_compiles_the_serve_world(serving, card):
    from curriculum_learning_for_vln_torch.world import compiler, native, synthetic
    from curriculum_learning_for_vln_torch.world.graph import shortest_paths

    world = serving[0]
    assert native.native_available(), "the native graph library builds on this machine"
    graphs = synthetic.make_world_graphs(NUM_SCANS, NODES_PER_SCAN, seed=SEED)
    w_native = compiler.compile_world(graphs, 16)
    w_scipy = compiler.compile_world(graphs, 16, use_native=False)
    for name in ("cand_next", "cand_valid", "cand_heading", "cand_elev", "cand_view", "n_cands"):
        assert np.array_equal(getattr(w_native, name), getattr(w_scipy, name)), f"native {name}"
    assert np.array_equal(w_native.next_hop, world.next_hop) \
        and np.array_equal(w_native.dist, world.dist), "the serve world was compiled natively"
    dist_err = float(np.abs(w_native.dist - w_scipy.dist).max())
    assert dist_err <= 1e-4, f"native distances within 1e-4 of scipy's: {dist_err}"
    for s_i, scan in enumerate(w_native.scan_ids):
        g, off = graphs[scan], int(w_native.scan_offset[s_i])
        V = g.num_nodes
        nh = w_native.next_hop[off:off + V, :V] - off
        sd = shortest_paths(g)[0]
        for a, b in zip(*np.nonzero(nh != w_scipy.next_hop[off:off + V, :V] - off)):
            hop = nh[a, b]
            assert abs(sd[a, b] - np.linalg.norm(g.pos[a] - g.pos[hop]) - sd[hop, b]) <= 1e-3, \
                f"native next hop {a}->{b} via {hop} is on a shortest path"
