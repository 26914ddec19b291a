"""EnvDrop served on the card at the full width of
``configs/envdrop/envdrop_config.yaml`` (seeded random weights), on a
synthetic world of 12 scans x 64 nodes with 2048-d features: micro-batches
of 64 requests through ``Navigator.navigate_batch``, in bf16 and f32.

The launches of every call are exact (K3 twice, K4 and K6 once a decoder
step), the trajectories walk the graph, and the first step's logits
agree with the plain versions on the card; in f32 the trajectories are
the plain versions' but after a tie of the two best logits.
"""
import pytest
from torch_card_world import (BATCH, assert_trajectories, card, compare_actions,  # noqa: F401
                              first_step_logits, launch_counts, launches_of, plain_kernels,
                              reset_launch_counts, serving)


@pytest.fixture(scope="module", params=["bf16", "f32"])
def served(request, serving, card):
    """Every micro-batch of the requests served once through the kernels,
    counted: (precision, navigator, batches, outputs, launches)."""
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.serve import Navigator
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    world, _, requests, tok, cfg, m, params = serving
    precision = request.param
    agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), world.features.shape[-1],
                         cfg.AGENT.MAX_EPISODE_LEN, compute_dtype=PRECISIONS[precision])
    nav = Navigator(world, agent, params, tok, max_batch=BATCH, precision=precision, device=card)
    batches = [requests[i:i + BATCH] for i in range(0, len(requests), BATCH)]
    reset_launch_counts()
    outs = [o for reqs in batches for o in nav.navigate_batch(reqs)]
    return precision, nav, batches, outs, launch_counts()


def test_serve_launches_k3_twice_and_k4_k6_a_step(served):
    precision, nav, batches, _, counts = served
    T, calls = nav.agent.episode_len, len(batches)
    want = launches_of(lstm_scan=2 * calls, pano_attend=T * calls, cand_score=T * calls)
    assert counts == want, f"{precision} serve launches {counts} over {calls} calls of {T} steps"
    assert counts["lstm_scan"] > 0, "K3 launches on its main path"


def test_serve_trajectories_walk_the_graph(served, serving):
    world, _, requests, *_ = serving
    _, nav, _, outs, _ = served
    assert_trajectories(world, requests, outs, nav.agent.episode_len)


def test_serve_agrees_with_plain_versions(served):
    """First-step logits within 1e-4 of their scale: f32 sums of up to 2176
    products, in another order, whose magnitudes add up to some 50 times the
    result (a relative error near 1e-5)."""
    precision, nav, batches, outs, _ = served
    ep = nav.episodes(batches[0])
    res_k = nav.rollout(ep)
    with plain_kernels():
        res_p = nav.rollout(ep)
        outs_p = nav.navigate_batch(batches[0])
    err, scale = first_step_logits(res_k, res_p)
    rel, tol = err / max(scale, 1.0), 1e-4
    assert rel <= tol, f"{precision}: first-step logits |kernel - plain| / scale = {rel:.3g}"
    if precision == "f32" and compare_actions(res_k, res_p, tol * max(scale, 1.0)) == 0:
        assert outs_p == outs[:BATCH], "f32 trajectories equal with the plain versions"
