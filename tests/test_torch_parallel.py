"""The port's data parallelism (parallel/mesh.py) against the JAX package.

* the mesh's shape from TPU.MESH_DATA / MESH_MODEL and a batch size, and
  ``pad_batch_to_devices``, against JAX's on the suite's 8-device virtual
  CPU mesh;
* the global draws: in a sharded step, rank r's dropout masks (batch on
  axis 0 and on axis 1), Gumbel noise and env-dropout of every mask mode
  are rows r * B / N ... of one process's draws from the same generator,
  which ends in the same state (ranks simulated in this process, up to B
  = 16 over N = 8 in prng_shared, where a rank's two rows take the
  global group's seed); a prng_shared layout whose ranks straddle the
  groups of 8 raises; a draw that names no batch axis raises there;
* ``reduce_logs`` refuses a log of no known kind; the backend rule over
  hosts' layouts (``local_layout``, ``backend_for``);
* one DP step of the port, N = 2 and 4 spawned CPU ranks (gloo), SGD
  with teacher feedback from converted parameters, EnvDrop (the clip at
  40, ML / B) and the Follower (the mean over the alive samples), against
  JAX's sharded step on the virtual mesh (data = N): the loss and every
  updated leaf within 1e-4, every rank the same; the ranks load no JAX.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dp_workers as W
from test_torch_follower import episode_batches

from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent as TEnvDrop
from curriculum_learning_for_vln_torch.agents.follower import FollowerAgent as TFollower
from curriculum_learning_for_vln_torch.convert import params_from_jax
from curriculum_learning_for_vln_torch.engine import loop as t_loop
from curriculum_learning_for_vln_torch.models.core import dropout
from curriculum_learning_for_vln_torch.ops import draws, philox
from curriculum_learning_for_vln_torch.parallel import mesh as TM
from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults as t_cfg
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents.envdrop import EnvDropAgent as JEnvDrop
from curriculum_learning_for_vln_tpu.agents.follower import FollowerAgent as JFollower
from curriculum_learning_for_vln_tpu.engine import loop as j_loop
from curriculum_learning_for_vln_tpu.parallel import mesh as JM
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults as j_cfg

torch.set_num_threads(2)

FEAT_DIM, ENC_LEN, EPISODE_LEN, B = 64, 12, 6, 16
ATOL = 1e-4
LR = 0.5  # SGD: the update is linear in the gradient, and this one moves every leaf


@pytest.mark.parametrize("data,model,batch", [(0, 1, 16), (0, 1, 12), (4, 2, 16), (0, 2, 6),
                                              (3, 1, 9), (0, 4, 10), (16, 1, 8), (1, 8, 5)])
def test_mesh_shape_matches_jax(data, model, batch):
    cfg = j_cfg()
    cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL = data, model
    mesh = JM.mesh_from_config(cfg, batch)
    assert TM.mesh_shape(jax.device_count(), data, model, batch) == (
        mesh.shape["data"], mesh.shape["model"])


@pytest.mark.parametrize("data", [1, 2, 4, 8])
def test_pad_batch_to_devices_matches_jax(data):
    jmesh = JM.make_mesh(data=data, model=1, devices=jax.devices()[:data])
    tmesh = types.SimpleNamespace(data=data)
    for n in range(1, 20):
        assert TM.pad_batch_to_devices(n, tmesh) == JM.pad_batch_to_devices(n, jmesh)


def test_one_process_mesh_and_rows():
    """Without a process group: the 1 x 1 mesh, whole batches, no collective."""
    mesh = TM.mesh_from_config(t_cfg(), 64)
    assert (mesh.data, mesh.model, mesh.distributed) == (1, 1, False)
    x = torch.arange(6.0)
    assert torch.equal(TM.shard_batch({"x": x}, mesh)["x"], x)
    with TM.sharded_step(mesh):
        assert TM.step_mesh() is None and TM.global_sum(x) is x and TM.global_rows(6) == 6
    with pytest.raises(ValueError, match="every one of the 1 ranks"):
        TM.make_mesh(data=2)  # a second rank's rows would go nowhere
    two = types.SimpleNamespace(data=2, data_index=1)
    assert TM.batch_rows(two, 6) == slice(3, 6)
    with pytest.raises(ValueError, match="does not split"):
        TM.batch_rows(two, 5)


def _fake_rank(n, r):
    """A rank's place in an n-rank data axis, for the draws (no collective)."""
    return types.SimpleNamespace(data=n, data_index=r, model=1, distributed=True)


def _envdrop_agent():
    m = t_cfg().MODEL.ENVDROP
    return TEnvDrop(m, ENC_LEN, 40, FEAT_DIM, EPISODE_LEN)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_rank_draws_are_rows_of_one_process(n):
    agent = _envdrop_agent()
    whole = W.draws_of(None, B, agent)
    per = B // n
    for r in range(n):
        got = W.draws_of(_fake_rank(n, r), per, agent)
        rows = slice(r * per, (r + 1) * per)
        assert torch.equal(got["generator"], whole["generator"])
        for k in ("dropout", "gumbel"):
            assert torch.equal(got[k], whole[k][rows]), k
        assert torch.equal(got["dropout_t"], whole["dropout_t"][:, rows])
        assert torch.equal(got["prng"].seeds, whole["prng"].seeds[rows])
        assert torch.equal(got["ext"].mask, whole["ext"].mask[rows])
        # prng_shared: each row's effective seed (the kernels' grouping of
        # the rank's rows) is its global group's, and so is its mask
        eff = philox.group_seeds(got["prng_shared"].seeds)
        want = philox.group_seeds(whole["prng_shared"].seeds)[rows]
        assert torch.equal(eff, want)
        assert torch.equal(philox.keep_mask(eff, (4, 6), 0.7),
                           philox.keep_mask(want, (4, 6), 0.7))


def test_a_draw_without_its_batch_axis_raises_in_a_sharded_step():
    """Inside a sharded step every draw names its batch axis: a site that
    names none would cut its rows from axis 0, wrong for a batch on another
    axis; outside one (or at data = 1) nothing is cut and nothing raises."""
    gen = torch.Generator().manual_seed(0)
    with TM.sharded_step(_fake_rank(2, 1)):
        with pytest.raises(ValueError, match="names no batch axis"):
            draws.rand((3, 4), gen, "cpu")
        with pytest.raises(ValueError, match="names no batch axis"):
            dropout(torch.ones(3, 4), 0.5, True, gen)
        assert draws.rand((3, 4), gen, "cpu", batch_dim=1).shape == (3, 4)
        assert draws.randint(0, 9, (5,), gen, "cpu", batch_dim=None).shape == (5,)
    with TM.sharded_step(_fake_rank(1, 0)):
        assert draws.rand((3, 4), gen, "cpu").shape == (3, 4)
    assert dropout(torch.ones(3, 4), 0.5, True, gen).shape == (3, 4)


def test_reduce_logs_refuses_a_key_of_no_known_kind():
    """Every logged key is summed over the ranks, held whole, or gathered by
    rows; a new key of none of these kinds raises, with or without ranks."""
    logs = {k: torch.ones(()) for k in t_loop.SUMMED_LOGS + t_loop.GLOBAL_LOGS}
    logs["loss_per_sample"] = torch.ones(4)
    assert t_loop.reduce_logs(logs, None) is logs
    with pytest.raises(KeyError, match="new_total"):
        t_loop.reduce_logs(dict(logs, new_total=torch.ones(())), None)


def _local(rank, world):
    return {"LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world)}


@pytest.mark.parametrize("world,rank,cards,env,want", [
    (16, 9, 8, {}, ValueError),                  # 2 hosts x 8 GPUs started by VLN_*
    (16, 9, 8, _local(1, 8), ("nccl", 1)),       # ... with its host's ranks named
    (2, 1, 1, _local(1, 2), ("gloo", 0)),        # 2 ranks sharing one card
    (2, 1, 1, {}, ValueError),                   # ... unnamed: the layout is not known
    (4, 3, 8, {}, ("nccl", 3)),                  # one host, a card a rank
    (1, 0, 1, {}, ("nccl", 0)),                  # world size 1
    (2, 0, 8, {"LOCAL_RANK": "0"}, ValueError),  # LOCAL_RANK alone
])
def test_backend_rule_over_host_layouts(monkeypatch, world, rank, cards, env, want):
    """``local_layout`` and ``backend_for``: NCCL when every rank of a host
    owns a card, gloo when they share one; a CUDA world larger than the
    host's cards must name its host's ranks (LOCAL_RANK, LOCAL_WORLD_SIZE)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if want is ValueError:
        with pytest.raises(ValueError, match="LOCAL_"):
            TM.local_layout(world, rank, "cuda")
        return
    local_rank, local_world = TM.local_layout(world, rank, "cuda")
    card = torch.device("cuda", local_rank % cards)
    assert (TM.backend_for(card, local_world), card.index) == want
    assert TM.backend_for(torch.device("cpu"), local_world) == "gloo"


def test_prng_shared_refuses_straddling_groups():
    agent = _envdrop_agent()
    agent.obs_masks = "prng_shared"
    gen = torch.Generator().manual_seed(0)
    with TM.sharded_step(_fake_rank(2, 1)), pytest.raises(ValueError, match="straddle"):
        agent._obs_drop(12, 4, 6, True, "cpu", gen)  # 24 rows: rank 1 starts mid-group


# ---------------------------------------------------------------------------
# one DP step against JAX's sharded step
# ---------------------------------------------------------------------------

def _cfgs():
    cfgs = {}
    for make, side in ((j_cfg, "j"), (t_cfg, "t")):
        c = make().MODEL
        c.ENVDROP.WORD_EMB_SIZE, c.ENVDROP.ACT_EMB_SIZE, c.ENVDROP.HIDDEN_SIZE = 16, 16, 32
        c.ENVDROP.DROP_RATE = c.ENVDROP.FEAT_DROP_RATE = 0.0
        c.ENVDROP.ML_WEIGHT = 0.2  # the shipped configs' (the default is 0)
        c.FOLLOWER.WORD_EMB_SIZE, c.FOLLOWER.HIDDEN_SIZE = 30, 32
        c.FOLLOWER.DROP_RATE = 0.0
        cfgs[side] = c
    return cfgs


@pytest.fixture(scope="module")
def dp_step(synth_world, synth_graphs, synth_dataset, tokenizer):
    """JAX's sharded step at data = 2 and 4, and the port's ranks' steps."""
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    t_world.features = synth_world.features.copy()
    tok = type(tokenizer)(tokenizer.vocab, encoding_length=ENC_LEN)
    j_ep, t_ep = episode_batches(synth_world, synth_dataset, tok, B)
    cfgs = _cfgs()
    V = tok.vocab_size()
    agents = {"ENVDROP": (JEnvDrop(cfgs["j"].ENVDROP, ENC_LEN, V, FEAT_DIM, EPISODE_LEN),
                          TEnvDrop(cfgs["t"].ENVDROP, ENC_LEN, V, FEAT_DIM, EPISODE_LEN)),
              "FOLLOWER": (JFollower(cfgs["j"].FOLLOWER, V, FEAT_DIM, EPISODE_LEN),
                           TFollower(cfgs["t"].FOLLOWER, V, FEAT_DIM, EPISODE_LEN))}
    tables = synth_world.device_tables("f32")
    opt = j_loop.make_optimizer("sgd", LR)
    cases, want = [], {}
    for name, (j_agent, t_agent) in agents.items():
        params, mstate = j_agent.init(jax.random.PRNGKey(0))
        step = j_loop.build_train_step(j_agent, opt, "teacher")
        for n in (2, 4):
            mesh = JM.make_mesh(data=n, model=1, devices=jax.devices()[:n])
            p = jax.tree_util.tree_map(jnp.array, params)
            new, _, _, logs = step(tables, p, opt.init(p), mstate, JM.shard_batch(j_ep, mesh),
                                   jax.random.PRNGKey(1))
            want[name, n] = (jax.tree_util.tree_leaves(new), float(logs["loss"]), params)
        cases.append({"agent": t_agent, "world": t_world, "ep": t_ep, "lr": LR,
                      "params": params_from_jax(jax.tree_util.tree_map(np.asarray, params))})
    got = {n: W.spawn("step", n, {"cases": cases}) for n in (2, 4)}
    return want, got


@pytest.mark.parametrize("name", ["ENVDROP", "FOLLOWER"])
@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_matches_jax_sharded_step(dp_step, name, n):
    want, got = dp_step
    leaves_j, loss_j, params0 = want[name, n]
    i = ["ENVDROP", "FOLLOWER"].index(name)
    ranks = [out["steps"][i] for out in got[n]]
    assert not any(out["jax_loaded"] for out in got[n])
    for rank in ranks[1:]:  # every rank steps on the same global gradient
        for a, b in zip(rank["leaves"], ranks[0]["leaves"], strict=True):
            assert torch.equal(a, b)
    np.testing.assert_allclose(float(ranks[0]["logs"]["loss"]), loss_j, rtol=0, atol=ATOL)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(leaves_j, jax.tree_util.tree_leaves(params0)))
    assert moved > 100 * ATOL
    assert len(ranks[0]["leaves"]) == len(leaves_j)
    for t, j in zip(ranks[0]["leaves"], leaves_j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)
