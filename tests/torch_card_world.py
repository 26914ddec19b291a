"""What the port's card tests share (``tests/test_torch_card_*.py``).

The full-width serving world of the serve, train, curriculum, agents,
speaker, beam, BPTT and plain-route tests (EnvDrop at the width of
``configs/envdrop/envdrop_config.yaml``, seeded random weights, a
synthetic world of 12 scans x 64 nodes with 2048-d features), the
kernels' launch counters and their plain twins, the inputs of the kernel
checks, the comparisons and the expected launches of each path, and
``main`` run in a process of its own as a user runs it.

This module imports torch, numpy and the port only, never JAX, so that
the card tests run where the card is:

    python3 -m pytest -q --noconftest tests/test_torch_card_*.py tests/test_torch_keep_mask_card.py

(``--noconftest``: ``tests/conftest.py`` sets JAX up.)  Without a card
every card test skips at the ``card`` fixture, before any work.
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
from contextlib import contextmanager

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")

SEED = 0
BATCH = 64
NUM_SCANS, NODES_PER_SCAN, FEAT_DIM = 12, 64, 2048
CONFIG = "configs/envdrop/envdrop_config.yaml"
CL_CONFIG = "configs/envdrop/envdrop_cl_config.yaml"
VOCAB = "assets/train_vocab.txt"
SERVE_CALLS = 4          # distinct micro-batches of BATCH requests
MODES = ("none", "ext", "prng", "prng_shared")
AGENT_CONFIGS = {"FOLLOWER": ("configs/follower/follower_config.yaml",
                              "configs/follower/follower_cl_config.yaml"),
                 "SELF-MONITOR": ("configs/monitor/selfmonitor_config.yaml",
                                  "configs/monitor/selfmonitor_cl_config.yaml")}
AGENT_T = 10  # their configs' MAX_EPISODE_LEN
# the pipeline's synthetic world at full width (over 128 nodes a scan: 2048-d features)
SYN_SCANS, SYN_NODES = 6, 160

# name -> (launch counter: module, attribute)
KERNELS = {
    "lstm_scan_train": ("lstm_scan", "train_launches"),
    "lstm_scan_bwd": ("lstm_scan", "bwd_launches"),
    "lstm_scan": ("lstm_scan", "launches"),
    "pano_attend": ("pano_fused", "launches"),
    "pano_attend_bwd": ("pano_fused", "bwd_launches"),
    "cand_score": ("cand_score", "launches"),
    "cand_score_bwd": ("cand_score", "bwd_launches"),
    "lstm_cell": ("lstm_cell", "launches"),
}
# K8 is on no path of either package (ops/rnn.py keeps the decoder's cell
# plain): the kernel tests alone launch it.
OFF_PATH = ("lstm_cell",)

# leaves whose gradient is 0 but for f32 rounding: the Follower's b_v (the
# reparameterised query leaves it out) and ActionScoring's b_act and output
# bias (each adds one constant to every candidate's score); the
# Self-Monitor's BN-MLP input bias and first-layer bias (a BatchNorm takes
# out the shift)
ZERO_GRAD = {
    "FOLLOWER": {("decoder", "visual_attn", "linear_in_v", "b"),
                 ("decoder", "decode_action", "linear_act", "b"),
                 ("decoder", "decode_action", "linear_out", "b")},
    "SELF-MONITOR": {("decoder", "proj_navigable_mlp", "bn_in", "bias"),
                     ("decoder", "proj_navigable_mlp", "layers", 0, "b")},
}


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="session")
def card():
    """The card, the kernels built, TF32 off (the plain versions run in
    full f32); skips at once without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from curriculum_learning_for_vln_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    return torch.device("cuda")


@pytest.fixture(scope="session")
def serving(card):
    """``build_serving()``: (world, data, requests, tok, cfg, m, params)."""
    return build_serving()


# ---------------------------------------------------------------------------
# The serving world
# ---------------------------------------------------------------------------

def build_serving(num_scans=NUM_SCANS, nodes_per_scan=NODES_PER_SCAN, feat_dim=FEAT_DIM):
    """The synthetic world, its dataset items, the requests, tokenizer,
    EnvDrop config and seeded f32 parameters of the serve and train tests."""
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults
    from curriculum_learning_for_vln_torch.utils.tokenizer import Tokenizer, read_vocab
    from curriculum_learning_for_vln_torch.world import compiler, synthetic

    cfg = get_cfg_defaults()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(["TPU.PACKED_RL", 0, "TPU.OBS_MASKS", "prng"])
    m = cfg.MODEL.ENVDROP
    graphs = synthetic.make_world_graphs(num_scans, nodes_per_scan, seed=SEED)
    world = compiler.compile_world(graphs, 16)
    compiler.attach_synthetic_features(world, feature_dim=feat_dim)
    data = synthetic.make_r2r_dataset(graphs, num_paths=SERVE_CALLS * BATCH + 16, seed=SEED + 1)
    tok = Tokenizer(read_vocab(VOCAB), encoding_length=cfg.DATA.MAX_ENC_LEN)
    requests = [{"instruction": it["instructions"][0], "scan": it["scan"],
                 "start_viewpoint": it["path"][0], "heading": it["heading"]}
                for it in data[:SERVE_CALLS * BATCH]]
    assert len(requests) == SERVE_CALLS * BATCH, "enough synthetic requests"
    f32_agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), feat_dim,
                             cfg.AGENT.MAX_EPISODE_LEN)
    params = f32_agent.init(torch.Generator().manual_seed(SEED))
    return world, data, requests, tok, cfg, m, params


def curriculum_setup(world, data, tok, device):
    """The CL config as shipped (PACKED_RL 3, SPCL parameters) on the serving
    world: its train paths cut into 5 rounds by path length (as
    pipeline.build_synthetic_universe cuts the synthetic universe), the
    cumulative NAIVE round envs, the SELF-PACE env, and a val_unseen env
    of the paths the requests leave out."""
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.env.host_env import CLR2RBatchEnv, R2RBatchEnv
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(CL_CONFIG)
    assert cfg.TPU.PACKED_RL == 3, "the CL config ships PACKED_RL 3"
    naive, acc = {}, []
    rounds = length_rounds(data, tok)
    for k in range(1, 6):
        acc = acc + rounds[f"round_{k}"]
        naive[f"round_{k}"] = R2RBatchEnv(world, acc, BATCH, tok, SEED + k, device=device)
    spcl_env = CLR2RBatchEnv(world, rounds, BATCH, cfg.TRAIN.SELF_PACE.CRATE, tok, SEED,
                             device=device)
    valid = {"val_unseen": R2RBatchEnv(world, expand_r2r_items(data[SERVE_CALLS * BATCH:], tok),
                                       BATCH, tok, SEED + 12, "val_unseen", device=device)}
    return cfg, naive, spcl_env, valid


def length_rounds(data, tok):
    """The requests' paths cut into 5 rounds by path length."""
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items

    train = sorted(data[:SERVE_CALLS * BATCH], key=lambda it: it["distance"])
    per = len(train) // 5
    return {f"round_{k}": expand_r2r_items(train[(k - 1) * per: k * per if k < 5 else None], tok)
            for k in range(1, 6)}


def agent_cfg(config, *extra):
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(config)
    cfg.merge_from_list(list(extra))
    assert cfg.AGENT.MAX_EPISODE_LEN == AGENT_T, f"{config} ships T = {AGENT_T}"
    return cfg


# ---------------------------------------------------------------------------
# Launch counts and the plain twins
# ---------------------------------------------------------------------------

def modules():
    from curriculum_learning_for_vln_torch.ops.cuda import (cand_score, lstm_cell, lstm_scan,
                                                            pano_fused)

    return {"lstm_scan": lstm_scan, "pano_fused": pano_fused, "cand_score": cand_score,
            "lstm_cell": lstm_cell}


def launch_counts():
    mods = modules()
    return {name: getattr(mods[m], attr) for name, (m, attr) in KERNELS.items()}


def reset_launch_counts():
    mods = modules()
    for m, attr in KERNELS.values():
        setattr(mods[m], attr, 0)


def launches_of(**counts):
    """Every kernel's expected launches: the ones named, 0 for the rest."""
    want = dict.fromkeys(KERNELS, 0)
    want.update(counts)
    return want


def iteration_launches(t_il, T):
    """One EnvDrop iteration's launches: the encoder's 2 directions (K1, K2)
    in the IL and the A2C rollouts, K4 and K6 a step of each and one more
    for the bootstrap step, K5 and K7 a step of each."""
    return launches_of(lstm_scan_train=4, lstm_scan_bwd=4, pano_attend=t_il + T + 1,
                       cand_score=t_il + T + 1, pano_attend_bwd=t_il + T, cand_score_bwd=t_il + T)


def agent_launches(name, serve):
    """The exact launches of one serve call or one training iteration of
    the Follower or the Self-Monitor at T = AGENT.MAX_EPISODE_LEN steps:
    the Follower's 2-layer BiLSTM encoder runs K3 (serve) or K1 and K2
    (train) once per layer and direction, its observation op K4 (and K5
    under autograd) once a step; the Self-Monitor's 1-layer LSTM runs one
    K3 or K1 + K2, and K4 once a step on a query that carries no gradient,
    so no K5.  No path of either runs K6, K7 or K8."""
    enc = 4 if name == "FOLLOWER" else 1
    if serve:
        return launches_of(lstm_scan=enc, pano_attend=AGENT_T)
    return launches_of(lstm_scan_train=enc, lstm_scan_bwd=enc, pano_attend=AGENT_T,
                       pano_attend_bwd=AGENT_T if name == "FOLLOWER" else 0)


@contextmanager
def plain_kernels():
    """Route every kernel op to its plain version, on the card, for the
    reference runs; the wrappers' launch counts stay untouched."""
    mods = modules()
    names = {"lstm_scan": ("lstm_scan", "lstm_scan_train", "lstm_scan_bwd"),
             "pano_fused": ("pano_attend", "pano_attend_bwd"),
             "cand_score": ("cand_score", "cand_score_bwd"),
             "lstm_cell": ("lstm_cell",)}
    saved = {(m, f): getattr(mods[m], f) for m, fs in names.items() for f in fs}
    for (m, f) in saved:
        setattr(mods[m], f, getattr(mods[m], f + "_plain"))
    try:
        yield
    finally:
        for (m, f), fn in saved.items():
            setattr(mods[m], f, fn)


# ---------------------------------------------------------------------------
# Inputs and comparisons
# ---------------------------------------------------------------------------

def compare(got, want, rtol: float):
    """(max |got - want|, its tolerance rtol * max(1, max |want|)) over
    pairs of tensors."""
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.float().abs().max()) for w in want)
    return err, rtol * max(1.0, scale)


def drop_spec(mode, B, rows, D, gen, device, keep=0.7):
    from curriculum_learning_for_vln_torch.ops import philox
    from curriculum_learning_for_vln_torch.ops.cuda.drop import NO_DROP, DropSpec

    if mode == "none":
        return NO_DROP
    if mode == "ext":
        return DropSpec("ext", mask=torch.rand((B, rows, D), generator=gen, device=device) < keep,
                        keep=keep)
    return DropSpec(mode, seeds=philox.draw_seeds(B, gen, device), keep=keep)


def lstm_inputs(dtype, device, gen, B, L=80, D=256, H=256):
    def u(*shape):
        return ((torch.rand(*shape, generator=gen, device=device) * 2 - 1) / H ** 0.5).to(dtype)

    xs = torch.randn(B, L, D, generator=gen, device=device).to(dtype)
    return xs, u(D, 4 * H), u(H, 4 * H), u(4 * H)


def long_lengths(B, gen, device, lo=16, hi=80):
    """Token lengths uniform in lo..hi (hi = MAX_ENC_LEN, the cap that real
    R2R instructions reach), one of them hi: the LSTM kernels' serial loop
    runs to the longest row of each cluster."""
    lengths = torch.randint(lo, hi + 1, (B,), generator=gen, device=device)
    lengths[0] = hi
    return lengths


def leaf_paths(tree, prefix=()):
    """The key path of every leaf, in ``utils.tree.tree_leaves``' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, prefix + (i,))]
    return [] if tree is None else [prefix]


def finite(xs) -> bool:
    return all(x == x and abs(x) < float("inf") for x in xs)


def moved_leaves(before, leaves) -> int:
    return sum(int(not torch.equal(a, p.detach())) for a, p in zip(before, leaves))


def assert_trajectories(world, requests, outs, episode_len):
    for req, out in zip(requests, outs):
        traj = out["trajectory"]
        assert traj[0][0] == req["start_viewpoint"], "a trajectory starts at its start viewpoint"
        assert 1 <= len(traj) <= episode_len + 1, "a trajectory has at most one move per step"
        for a, b in zip(traj[:-1], traj[1:]):
            ga = world.global_id(req["scan"], a[0])
            gb = world.global_id(req["scan"], b[0])
            assert gb in world.cand_next[ga][world.cand_valid[ga]], \
                "a trajectory moves only between graph neighbours"


def compare_actions(res_k, res_p, tol):
    """Actions of two rollouts agree, sample by sample, up to the first
    step where the plain run's two best logits lie within ``tol`` (a tie
    the kernels' other summation order may break the other way); after
    such a step the two trajectories may rightly differ.  Returns the
    number of samples cut short by a tie."""
    act_k, act_p = res_k.steps.action.cpu(), res_p.steps.action.cpu()
    alive = res_p.steps.alive_before.cpu()
    top2 = res_p.steps.logits.float().topk(2, dim=-1).values.cpu()
    ties = 0
    for b in range(act_k.shape[1]):
        for t in range(act_k.shape[0]):
            if not alive[t, b]:
                break
            if act_k[t, b] != act_p[t, b]:
                assert float(top2[t, b, 0] - top2[t, b, 1]) <= tol, \
                    f"f32 actions of sample {b} differ at step {t} without a tie"
                ties += 1
                break
    return ties


def first_step_logits(res_k, res_p):
    """(|kernel - plain|, scale) of two rollouts' first-step logits, the
    same candidate slots masked in both."""
    l_k, l_p = res_k.steps.logits[0].float(), res_p.steps.logits[0].float()
    live = l_p > -1e29
    assert torch.equal(live, l_k > -1e29), "the same candidate slots are masked"
    return float((l_k - l_p)[live].abs().max()), float(l_p[live].abs().max())


# ---------------------------------------------------------------------------
# ``main`` as a user runs it
# ---------------------------------------------------------------------------

MAIN_WRAPPER = f"""\
import json, sys
sys.path.insert(0, {TESTS!r})
import torch_card_world
from curriculum_learning_for_vln_torch import main
main.main(*main.parse_args(sys.argv[1:]))
print("launches " + json.dumps(torch_card_world.launch_counts()))
"""


def start_main(args, d, env=None):
    """``main`` with ``args`` in a process of its own, as a user runs it,
    logging under ``d``, on the pipeline's synthetic world at full width,
    started; ``finish_main`` collects it."""
    cmd = [sys.executable, "-c", MAIN_WRAPPER, "--seed", str(SEED), *map(str, args),
           "TPU.SYNTHETIC_WORLD", "True", "TPU.SYNTHETIC_SCANS", SYN_SCANS,
           "TPU.SYNTHETIC_NODES", SYN_NODES, "OUTPUT.LOG_DIR", d, "OUTPUT.TSBOARD_DIR", "",
           "OUTPUT.CKPT_DIR", os.path.join(d, "ckpt")]
    return subprocess.Popen([str(c) for c in cmd], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=REPO,
                            env=None if env is None else dict(os.environ, **env))


def finish_main(what, proc, d):
    """(launches, the log's trainer and epoch lines, the log) of a started
    ``main``."""
    text_out = proc.communicate(timeout=600)[0]
    text = "".join(open(f).read() for f in glob.glob(os.path.join(d, "*.log")))
    counts = [json.loads(ln.split(" ", 1)[1]) for ln in text_out.splitlines()
              if ln.startswith("launches ")]
    assert proc.returncode == 0 and "Training finished" in text and len(counts) == 1, \
        f"main {what}: rc {proc.returncode}\n{text_out[-4000:]}"
    lines = [ln.split(": ", 1)[-1] for ln in text.splitlines() if "Epoch [" in ln or "Using" in ln]
    return counts[0], lines, text


# ---------------------------------------------------------------------------
# The compiler's report
# ---------------------------------------------------------------------------

def kernel_resources(log_text: str, kernel: str):
    """[(entry, registers, spill store bytes, spill load bytes)] of each
    instantiation of ``kernel`` in an ``nvcc -Xptxas -v`` report, matched
    by its mangled name (its length, then the name: ``recurrence_res_kernel``
    does not match ``bwd_recurrence_res_kernel``)."""
    mangled = f"{len(kernel)}{kernel}"
    out, entry, spills = [], None, (0, 0)
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and "bytes spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spills = (nums[1], nums[2])  # stack frame, spill stores, spill loads
        elif entry and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split()[0])
            if mangled in entry:
                out.append((entry, regs, *spills))
            entry, spills = None, (0, 0)
    return out
