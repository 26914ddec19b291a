"""R4R and the gt-route ("path") teacher in the port against the JAX
package:

* ``make_r4r_items``: the same joined items, in order, for several caps
  and seeds, on the synthetic dataset and on the shipped R2R splits;
* the path teacher's waypoint tables (``R2RBatchEnv(teacher_mode="path")``
  packs P = the longest route) and its actions: a teacher-following
  rollout over R4R batches (every step's teacher, node and trajectory),
  and a walk that leaves the route at random and rejoins it (the teacher,
  the waypoint pointer and the node at every step), exactly;
* on R2R items, whose gt routes are shortest paths, the path teacher is
  the goal teacher (SR 1, nDTW 1), and the goal teacher (P = 1) is JAX's,
  step for step, on any walk;
* the R4R scores of the port's ``Evaluation`` on string path ids, and the
  synthetic R4R branch of ``pipeline.build_environments``: the same items,
  tables and batch order as JAX's;
* the packed A2C pool over path-teacher episodes, against JAX's pool.

Everything here is integer or host arithmetic, held exactly, but the
packed pool's loss (within 1e-4: a rollout's f32 recurrence, as in
tests/test_torch_packed.py).
"""
import os

import jax
import numpy as np
import pytest
import torch

import curriculum_learning_for_vln_torch.agents.common as t_common
from curriculum_learning_for_vln_torch import pipeline as t_pipeline
from curriculum_learning_for_vln_torch.agents import build_agent as t_build_agent
from curriculum_learning_for_vln_torch.agents.common import assemble_trajectories
from curriculum_learning_for_vln_torch.agents.test_agent import TestAgent as TTestAgent
from curriculum_learning_for_vln_torch.data import datasets as t_ds
from curriculum_learning_for_vln_torch.convert import params_from_jax
from curriculum_learning_for_vln_torch.engine import evaluator as t_eval
from curriculum_learning_for_vln_torch.engine import loop as t_loop
from curriculum_learning_for_vln_torch.engine.trainer import dedup_by_path
from curriculum_learning_for_vln_torch.env import env as t_env
from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv as TEnv
from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults as t_cfg
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu import pipeline as j_pipeline
from curriculum_learning_for_vln_tpu.agents import TestAgent as JTestAgent
from curriculum_learning_for_vln_tpu.agents import assemble_trajectories as j_assemble
from curriculum_learning_for_vln_tpu.agents import build_agent as j_build_agent
from curriculum_learning_for_vln_tpu.data import datasets as j_ds
from curriculum_learning_for_vln_tpu.engine import evaluator as j_eval
from curriculum_learning_for_vln_tpu.engine.loop import concat_batches as j_concat
from curriculum_learning_for_vln_tpu.env import env as j_env
from curriculum_learning_for_vln_tpu.env.host_env import R2RBatchEnv as JEnv
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults as j_cfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 6


@pytest.fixture(scope="module")
def worlds(synth_world, synth_graphs):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16, use_native=False)
    t_world.features = synth_world.features.copy()
    return synth_world, t_world


@pytest.fixture(scope="module")
def r4r(synth_dataset):
    items = t_ds.make_r4r_items(synth_dataset, max_joins_per_anchor=2, seed=0)
    assert items and all(len(it["path"]) > 2 for it in items)
    return items


@pytest.mark.parametrize("joins,seed", [(1, 0), (1, 3), (2, 0), (10 ** 9, 3)])
def test_make_r4r_items_matches_jax(synth_dataset, joins, seed):
    got = t_ds.make_r4r_items(synth_dataset, joins, seed)
    assert got == j_ds.make_r4r_items(synth_dataset, joins, seed) and got
    for it in got:  # "<a>j<b>": a string id, a route through a's goal
        a, b = it["path_id"].split("j")
        assert a != b and isinstance(it["path_id"], str)


def test_make_r4r_items_matches_jax_on_the_shipped_r2r():
    items = t_ds.load_datasets(["val_seen"], "R2R", os.path.join(REPO, "assets"))
    got = t_ds.make_r4r_items(items, 1, 2020)
    assert len(got) > 20 and got == j_ds.make_r4r_items(items, 1, 2020)
    assert t_ds.dataset_scans(items) == j_ds.dataset_scans(items)


def _envs(worlds, items, tok, teacher_mode, name="val_seen"):
    j_world, t_world = worlds
    data = j_ds.expand_r2r_items(items, tok)
    return (JEnv(j_world, data, B, tok, 5, name, teacher_mode=teacher_mode),
            TEnv(t_world, data, B, tok, 5, name, teacher_mode=teacher_mode, device="cpu"))


def _t_batch(j_ep):
    return t_env.EpisodeBatch(*(torch.from_numpy(np.array(f).astype(np.int64)
                                                 if np.asarray(f).dtype.kind == "i"
                                                 else np.array(f)) for f in j_ep))


def test_path_tables_match_jax(worlds, r4r, tokenizer):
    je, te = _envs(worlds, r4r, tokenizer, "path")
    P = max(len(it["path"]) for it in r4r)
    assert te.path_local.shape == je.path_local.shape == (len(te.data), P)
    np.testing.assert_array_equal(te.path_local, je.path_local)
    np.testing.assert_array_equal(te.path_len, je.path_len)
    for _ in range(4):
        t_ep, j_ep = te.next_batch(), je.next_batch()
        np.testing.assert_array_equal(t_ep.path_local.numpy(), np.asarray(j_ep.path_local))
        np.testing.assert_array_equal(t_ep.path_len.numpy(), np.asarray(j_ep.path_len))
    je, te = _envs(worlds, r4r, tokenizer, "goal")  # the goal alone, P = 1
    np.testing.assert_array_equal(te.path_local, te.goal_local[:, None])
    np.testing.assert_array_equal(te.path_local, je.path_local)
    with pytest.raises(ValueError, match="teacher_mode"):
        TEnv(worlds[1], te.data, B, tokenizer, teacher_mode="route", device="cpu")


def _rollouts(worlds, items, tok, teacher_mode, episode_len=20, with_jax=True):
    """TestAgent over every eval batch of both packages (or the port's
    alone): (the port's and JAX's results, the port's and JAX's
    trajectories)."""
    j_world, t_world = worlds
    je, te = _envs(worlds, items, tok, teacher_mode)
    jt, tt = j_world.device_tables(), t_world.device_tables("f32", "cpu")
    out = {"t": [], "j": [], "t_traj": [], "j_traj": []}
    for t_ep, j_ep in zip(te.eval_batches(), je.eval_batches()):
        _, tr, _ = TTestAgent(episode_len).rollout({}, tt, t_ep)
        out["t"].append(tr)
        out["t_traj"] += assemble_trajectories(t_world, t_ep, tr, te.data)
        if with_jax:
            _, jr, _ = JTestAgent(episode_len).rollout({}, {}, jt, j_ep, jax.random.PRNGKey(0))
            out["j"].append(jr)
            out["j_traj"] += j_assemble(j_world, j_ep, jr, je.data)
    return out, te


@pytest.mark.parametrize("mode", ["path", "goal"])
def test_teacher_rollouts_match_jax(worlds, r4r, tokenizer, mode):
    out, te = _rollouts(worlds, r4r, tokenizer, mode)
    for tr, jr in zip(out["t"], out["j"]):
        for f in ("teacher", "node_after", "view_after", "moved", "alive_before"):
            np.testing.assert_array_equal(getattr(tr.steps, f).numpy(),
                                          np.asarray(getattr(jr.steps, f)), err_msg=f)
        np.testing.assert_array_equal(tr.final_state.path_ptr.numpy(),
                                      np.asarray(jr.final_state.path_ptr))
    assert out["t_traj"] == out["j_traj"]
    # the R4R scores of string path ids, one item a path as the trainer dedups
    items = dedup_by_path(te.data)
    assert [it["path_id"] for it in items] == [it["path_id"] for it in r4r]
    got, _ = t_eval.Evaluation(worlds[1], items, data_name="R4R").score(out["t_traj"])
    want, _ = j_eval.Evaluation(worlds[0], r4r, data_name="R4R").score(out["j_traj"])
    assert got == want and got["success_rate"] > 0.9
    if mode == "path":  # the route is followed; the goal teacher cuts it short
        assert got["ndtw"] > 0.95 and got["cls"] > 0.95
    else:
        assert got["ndtw"] < 0.95


@pytest.mark.parametrize("mode,items", [("path", "r4r"), ("goal", "r4r"), ("goal", "r2r")])
def test_teacher_off_the_route_matches_jax(worlds, r4r, synth_dataset, tokenizer, mode, items):
    """A walk that takes the teacher's action 60% of the time and a random
    candidate (or STOP) otherwise: the teacher's recovery toward its next
    waypoint, the pointer skipping to a rejoined route position, step for
    step."""
    j_world, t_world = worlds
    je, te = _envs(worlds, r4r if items == "r4r" else synth_dataset, tokenizer, mode)
    jt, tt = j_world.device_tables(), t_world.device_tables("f32", "cpu")
    rng = np.random.default_rng(7)
    skipped = 0
    for _ in range(6):
        j_ep = je.next_batch()
        js, ts = j_env.reset(jt, j_ep), t_env.reset(tt, _t_batch(j_ep))
        for _ in range(24):
            teacher = np.asarray(j_env.observe_meta(jt, js)[5])
            np.testing.assert_array_equal(t_env.observe_meta(tt, ts).teacher.numpy(), teacher)
            n = np.asarray(jt.n_cands[js.node])
            move = rng.integers(0, np.maximum(n, 1))  # a candidate slot
            u = rng.random(B)
            act = np.where(u < 0.6, teacher, np.where(u < 0.95, move, n))  # n: STOP
            ptr0 = np.asarray(js.path_ptr)
            js = j_env.step(jt, js, jax.numpy.asarray(act.astype(np.int32)))
            ts = t_env.step(tt, ts, torch.from_numpy(act.astype(np.int64)))
            for f in ("node", "view_idx", "ended", "path_ptr"):
                np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                              err_msg=f)
            skipped += int((np.asarray(js.path_ptr) - ptr0 > 1).sum())
    if mode == "goal":
        assert not np.asarray(js.path_ptr).any()  # P = 1: the pointer never moves
    elif items == "r4r":
        assert skipped > 0  # some walks rejoined the route further on


def test_path_teacher_is_the_goal_teacher_on_r2r(worlds, synth_dataset, tokenizer):
    path, _ = _rollouts(worlds, synth_dataset, tokenizer, "path", 10, with_jax=False)
    goal, te = _rollouts(worlds, synth_dataset, tokenizer, "goal", 10, with_jax=False)
    for a, b in zip(path["t"], goal["t"]):
        assert torch.equal(a.steps.teacher, b.steps.teacher)
        assert torch.equal(a.steps.node_after, b.steps.node_after)
    s, _ = t_eval.Evaluation(worlds[1], dedup_by_path(te.data)).score(path["t_traj"])
    assert s["success_rate"] == 1.0 and s["ndtw"] > 0.99


def test_pipeline_builds_r4r_synthetic_as_jax():
    cfgs = []
    for make in (t_cfg, j_cfg):
        cfg = make()
        cfg.merge_from_list(["DATA.NAME", "R4R", "DATA.R4R_JOINS", 2, "TPU.SYNTHETIC_WORLD", True,
                             "TPU.SYNTHETIC_SCANS", 2, "TPU.SYNTHETIC_NODES", 20,
                             "TRAIN.BATCH_SIZE", 4, "DATA.MAX_ENC_LEN", 40, "AGENT.TEACHER",
                             "path", "DATA.TRAIN_VOCAB", os.path.join(REPO, "assets",
                                                                       "train_vocab.txt")])
        cfgs.append(cfg)
    t_tok, j_tok = t_pipeline.build_tokenizer(cfgs[0]), j_pipeline.build_tokenizer(cfgs[1])
    _, t_train, t_valid, _ = t_pipeline.build_environments(cfgs[0], t_tok, seed=2020,
                                                           device="cpu")
    _, j_train, j_valid, _ = j_pipeline.build_environments(cfgs[1], j_tok, seed=2020)
    assert set(t_valid) == set(j_valid) == {"val_seen", "val_unseen"}
    for te, je in [(t_train, j_train)] + [(t_valid[k], j_valid[k]) for k in j_valid]:
        assert te.size() > 0 and te.teacher_mode == je.teacher_mode == "path"
        assert all("j" in str(it["path_id"]) for it in te.data)
        assert [it["instr_id"] for it in te.data] == [it["instr_id"] for it in je.data]
        np.testing.assert_array_equal(te.path_local, je.path_local)
        for _ in range(3):
            te.next_batch(), je.next_batch()
            np.testing.assert_array_equal(te.cur_batch_index, je.cur_batch_index)


@pytest.fixture()
def fixed_sampler(monkeypatch):
    noise = np.random.default_rng(5).gumbel(size=(B, 17)).astype(np.float32)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jax.numpy.argmax(logits + noise, axis=axis))
    monkeypatch.setattr(t_common, "gumbel_noise",
                        lambda shape, generator, device: torch.from_numpy(noise))


def test_packed_pool_with_the_path_teacher_matches_jax(worlds, r4r, tokenizer, fixed_sampler):
    """The packed A2C pool refills ended slots from path-teacher episodes by
    whole-state selects, as JAX's tree ops do (the pointer of a refilled
    slot restarts at 0; JAX's packed.py never names it): the same slots,
    rewards, losses and final states, pointer included, from JAX's
    parameters with dropout 0 and both samplers replayed."""
    j_world, t_world = worlds
    je, te = _envs(worlds, r4r, tokenizer, "path", name="train")
    j_c, t_c = j_cfg(), t_cfg()
    for cfg in (j_c, t_c):
        cfg.merge_from_list(["MODEL.NAME", "ENVDROP", "MODEL.ENVDROP.WORD_EMB_SIZE", 32,
                             "MODEL.ENVDROP.ACT_EMB_SIZE", 16,
                             "MODEL.ENVDROP.HIDDEN_SIZE", 64, "MODEL.ENVDROP.DROP_RATE", 0.0,
                             "MODEL.ENVDROP.FEAT_DROP_RATE", 0.0, "TPU.PRECISION", "f32",
                             "DATA.MAX_ENC_LEN", tokenizer.encoding_length,
                             "AGENT.MAX_EPISODE_LEN", 16])
    j_agent = j_build_agent(j_c, tokenizer.vocab_size(), 64)
    t_agent = t_build_agent(t_c, tokenizer.vocab_size(), 64)
    j_params, mstate = j_agent.init(jax.random.PRNGKey(0))
    j_pool = j_concat([je.next_batch() for _ in range(3)])
    t_pool = t_loop.concat_batches([te.next_batch() for _ in range(3)])
    np.testing.assert_array_equal(t_pool.path_local.numpy(), np.asarray(j_pool.path_local))
    jl, jr = j_agent.rollout_packed(j_params, mstate, j_world.device_tables(), j_pool,
                                    jax.random.PRNGKey(1), batch_size=B)
    tl, tr = t_agent.rollout_packed(params_from_jax(jax.tree_util.tree_map(np.asarray, j_params)),
                                    t_world.device_tables("f32", "cpu"), t_pool, batch_size=B,
                                    generator=torch.Generator().manual_seed(1))
    assert int(tr.episodes_started) == int(jr.episodes_started) > B  # slots were refilled
    for f in ("slot_ep", "alive_before", "ended_now", "reward"):
        np.testing.assert_array_equal(getattr(tr.steps, f).numpy(), np.asarray(getattr(jr.steps, f)),
                                      err_msg=f)
    for f in ("node", "view_idx", "ended", "path_local", "path_len", "path_ptr"):
        np.testing.assert_array_equal(getattr(tr.final_state, f).numpy(),
                                      np.asarray(getattr(jr.final_state, f)), err_msg=f)
    np.testing.assert_allclose(float(tl.rl_loss.detach()), float(jl.rl_loss), rtol=0, atol=1e-4)
