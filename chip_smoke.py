#!/usr/bin/env python3
"""Drive the PyTorch port's EnvDrop serving path on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the torch
   and CUDA versions.
2. Builds the port's three CUDA kernels from ``curriculum_learning_for_
   vln_torch/csrc`` (one ``nvcc`` per source, all at once) and prints the
   compiler's register and spill report.
3. Kernel phases: K3 (LSTM scan), K4 (observation step) and K6
   (candidate scoring), each on the card at the serving path's shapes in
   bf16 and f32, held against its plain PyTorch version on the same
   inputs, and timed with CUDA events beside its plain version, one
   PyTorch library call, and the least time the card could take.
4. Serve phase: EnvDrop at the full width of
   ``configs/envdrop/envdrop_config.yaml`` (random weights from a seed)
   on a synthetic world of 12 scans x 64 nodes with 2048-d features in
   ``TPU.PRECISION``, answering micro-batches of 64 requests through
   ``Navigator.navigate_batch``.  Checks the trajectories, that every
   call launched K3 twice and K4 and K6 once per decoder step, and that
   the same requests served with the plain versions on the card give the
   same first-step logits (and, in f32, the same actions).  Prints the
   latency per call and a profile of one call.
5. Prints one ``{"kernels": [...]}`` line, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line.  Without a CUDA device, or without the port beside it, it fails.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

import torch

SEED = 0
BATCH = 64
NUM_SCANS, NODES_PER_SCAN, FEAT_DIM = 12, 64, 2048
CONFIG = "configs/envdrop/envdrop_config.yaml"
VOCAB = "assets/train_vocab.txt"
SERVE_CALLS = 4          # distinct micro-batches of BATCH requests
SERVE_ROUNDS = 3         # timed passes over them

# Published H100 SXM peaks (dense), used for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

KERNEL_NAMES = ("lstm_scan", "pano_attend", "cand_score")


def log(*args):
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` back-to-back calls."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# Kernel phases
# ---------------------------------------------------------------------------

def lstm_phase(dtype, device, gen, lengths, L=80, D=256, H=256, iters=20):
    """K3 at the encoder's shapes, both directions of the BiLSTM, over the
    token lengths of a micro-batch of the serve phase's requests."""
    from curriculum_learning_for_vln_torch.ops.cuda import lstm_scan as k

    B = lengths.shape[0]
    xs = torch.randn(B, L, D, generator=gen, device=device).to(dtype)
    w_ih = ((torch.rand(D, 4 * H, generator=gen, device=device) * 2 - 1) / H ** 0.5).to(dtype)
    w_hh = ((torch.rand(H, 4 * H, generator=gen, device=device) * 2 - 1) / H ** 0.5).to(dtype)
    b = ((torch.rand(4 * H, generator=gen, device=device) * 2 - 1) / H ** 0.5).to(dtype)
    err = 0.0
    for reverse in (False, True):
        out_k, (h_k, c_k) = k.lstm_scan(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        out_p, (h_p, c_p) = k.lstm_scan_plain(xs, lengths, w_ih, w_hh, b, reverse=reverse)
        err = max(err, max_err((out_k, h_k, c_k), (out_p, h_p, c_p)))
    ms = cuda_time_ms(lambda i: k.lstm_scan(xs, lengths, w_ih, w_hh, b, reverse=bool(i & 1)), iters)
    plain_ms = cuda_time_ms(lambda i: k.lstm_scan_plain(xs, lengths, w_ih, w_hh, b), 3, warmup=1)

    lib_ms = None
    lstm = torch.nn.LSTM(D, H, batch_first=True).to(device=device, dtype=dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih.t())
        lstm.weight_hh_l0.copy_(w_hh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
        lstm.flatten_parameters()
        packed = torch.nn.utils.rnn.pack_padded_sequence(xs, lengths.cpu(), batch_first=True,
                                                         enforce_sorted=False)
        try:
            lib_ms = cuda_time_ms(lambda i: lstm(packed), iters)
        except RuntimeError as e:  # a cuDNN RNN without this dtype: no yardstick
            log(f"  torch.nn.LSTM in {dtype}: {e}".splitlines()[0])
    # per direction: each input read once, each output written once; the
    # products of this run's valid steps only
    moved = nbytes(xs, lengths, w_ih, w_hh, b) + B * L * H * 4 + 2 * B * H * 4
    flops = 2 * int(lengths.sum()) * (D + H) * 4 * H
    return {"name": "lstm_scan", "max_abs_err": err, "tol": 1e-4, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_call": "torch.nn.LSTM on a packed sequence (forward direction)",
            "bound": bound_ms(moved, flops, dtype)}


def pano_phase(dtype, device, gen, features, B=BATCH, MC=16, iters=200):
    """K4 at one decoder step's shapes over the serving world's table."""
    from curriculum_learning_for_vln_torch.ops.cuda import pano_fused as k
    from curriculum_learning_for_vln_torch.utils.angles import all_loc_embeddings

    N, V, D = features.shape
    A = 128
    loc = torch.from_numpy(all_loc_embeddings()).to(device)
    # eight index sets whose rows together exceed the 50 MB L2, so the
    # timed launches read their rows from device memory as a rollout does
    node_sets = [torch.randint(0, N, (B,), generator=gen, device=device) for _ in range(8)]
    views = torch.randint(0, V, (B,), generator=gen, device=device)
    cand_view = torch.randint(0, V, (B, MC), generator=gen, device=device)
    tv = torch.randn(B, D + A, generator=gen, device=device) / 32  # scores of O(1)
    args = (node_sets[0], views, cand_view, features, loc, tv)
    got, want = k.pano_attend(*args), k.pano_attend_plain(*args)
    check(torch.equal(got[2], want[2]), "pano_attend: candidate rows are exact copies")
    err = max_err(got[:2], want[:2])
    ms = cuda_time_ms(lambda i: k.pano_attend(node_sets[i % 8], views, cand_view, features,
                                              loc, tv), iters)
    plain_ms = cuda_time_ms(lambda i: k.pano_attend_plain(node_sets[i % 8], views, cand_view,
                                                          features, loc, tv), 20)
    rows = int(torch.unique(node_sets[0]).numel()) * V * D * features.element_size()
    loc_rows = int(torch.unique(views).numel()) * V * A * 4
    moved = (rows + loc_rows + nbytes(node_sets[0], views, cand_view, tv)
             + nbytes(*got))
    flops = 4 * B * V * (D + A)  # scores and the weighted sum
    return {"name": "pano_attend", "max_abs_err": err, "tol": 1e-4, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "library_call": "none: no one PyTorch call gathers, attends and copies rows",
            "bound": bound_ms(moved, flops, dtype)}


def cand_phase(dtype, device, gen, features, B=BATCH, MC=16, iters=200):
    """K6 at one decoder step's shapes."""
    from curriculum_learning_for_vln_torch.ops.cuda import cand_score as k

    N, V, D = features.shape
    A = 128
    nodes = torch.randint(0, N, (B,), generator=gen, device=device)
    cand_view = torch.randint(0, V, (B, MC), generator=gen, device=device)
    cand_img = features[nodes[:, None], cand_view].contiguous()         # [B, MC, D]
    cand_angle = torch.randn(B, MC, A, generator=gen, device=device)
    valid = torch.rand(B, MC, generator=gen, device=device) < 0.5
    q = torch.randn(B, D + A, generator=gen, device=device) / 32
    got = k.cand_score(cand_img, cand_angle, valid, q)
    want = k.cand_score_plain(cand_img, cand_angle, valid, q)
    check(bool((got[:, MC] == 0).all()), "cand_score: the STOP slot scores 0")
    err = max_err((got,), (want,))
    ms = cuda_time_ms(lambda i: k.cand_score(cand_img, cand_angle, valid, q), iters)
    plain_ms = cuda_time_ms(lambda i: k.cand_score_plain(cand_img, cand_angle, valid, q), 50)
    q_img = q[:, :D].to(dtype).contiguous()
    lib_ms = cuda_time_ms(lambda i: torch.einsum("bkd,bd->bk", cand_img, q_img), iters)
    moved = nbytes(cand_img, cand_angle, valid, q, got)
    flops = 2 * B * MC * (D + A)
    return {"name": "cand_score", "max_abs_err": err, "tol": 1e-4, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_call": "torch.einsum('bkd,bd->bk') over the image rows",
            "bound": bound_ms(moved, flops, dtype)}


# ---------------------------------------------------------------------------
# Serve phase
# ---------------------------------------------------------------------------

@contextmanager
def plain_kernels():
    """Route the three ops to their plain versions, on the card, for the
    reference run; the wrappers' launch counts stay untouched."""
    from curriculum_learning_for_vln_torch.ops.cuda import cand_score, lstm_scan, pano_fused

    saved = (lstm_scan.lstm_scan, pano_fused.pano_attend, cand_score.cand_score)
    lstm_scan.lstm_scan = lstm_scan.lstm_scan_plain
    pano_fused.pano_attend = pano_fused.pano_attend_plain
    cand_score.cand_score = cand_score.cand_score_plain
    try:
        yield
    finally:
        lstm_scan.lstm_scan, pano_fused.pano_attend, cand_score.cand_score = saved


def launch_counts():
    from curriculum_learning_for_vln_torch.ops.cuda import cand_score, lstm_scan, pano_fused

    return {"lstm_scan": lstm_scan.launches, "pano_attend": pano_fused.launches,
            "cand_score": cand_score.launches}


def reset_launch_counts():
    from curriculum_learning_for_vln_torch.ops.cuda import cand_score, lstm_scan, pano_fused

    lstm_scan.launches = pano_fused.launches = cand_score.launches = 0


def build_serving(num_scans=NUM_SCANS, nodes_per_scan=NODES_PER_SCAN, feat_dim=FEAT_DIM):
    """The synthetic world, requests, tokenizer, EnvDrop config and
    seeded f32 parameters of the serve phase."""
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults
    from curriculum_learning_for_vln_torch.utils.tokenizer import Tokenizer, read_vocab
    from curriculum_learning_for_vln_torch.world import compiler, synthetic

    cfg = get_cfg_defaults()
    cfg.merge_from_file(CONFIG)
    m = cfg.MODEL.ENVDROP
    graphs = synthetic.make_world_graphs(num_scans, nodes_per_scan, seed=SEED)
    world = compiler.compile_world(graphs, 16)
    compiler.attach_synthetic_features(world, feature_dim=feat_dim)
    data = synthetic.make_r2r_dataset(graphs, num_paths=SERVE_CALLS * BATCH + 16, seed=SEED + 1)
    tok = Tokenizer(read_vocab(VOCAB), encoding_length=cfg.DATA.MAX_ENC_LEN)
    requests = [{"instruction": it["instructions"][0], "scan": it["scan"],
                 "start_viewpoint": it["path"][0], "heading": it["heading"]}
                for it in data[:SERVE_CALLS * BATCH]]
    check(len(requests) == SERVE_CALLS * BATCH, "enough synthetic requests")
    f32_agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), feat_dim,
                             cfg.AGENT.MAX_EPISODE_LEN)
    params = f32_agent.init(torch.Generator().manual_seed(SEED))
    return world, requests, tok, cfg, m, params


def check_trajectories(world, requests, outs, episode_len):
    for req, out in zip(requests, outs):
        traj = out["trajectory"]
        check(traj[0][0] == req["start_viewpoint"], "a trajectory starts at its start viewpoint")
        check(1 <= len(traj) <= episode_len + 1, "a trajectory has at most one move per step")
        for a, b in zip(traj[:-1], traj[1:]):
            ga = world.global_id(req["scan"], a[0])
            gb = world.global_id(req["scan"], b[0])
            check(gb in world.cand_next[ga][world.cand_valid[ga]],
                  "a trajectory moves only between graph neighbours")


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
                check(float(top2[t, b, 0] - top2[t, b, 1]) <= tol,
                      f"f32 actions of sample {b} differ at step {t} without a tie")
                ties += 1
                break
    return ties


def serve_phase(world, requests, tok, m, params, episode_len, precision, device):
    """Serve every micro-batch through the kernels (counted), check the
    trajectories and the launches, and compare with the plain run."""
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.serve import Navigator
    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    agent = EnvDropAgent(m, tok.encoding_length, tok.vocab_size(), world.features.shape[-1],
                         episode_len, compute_dtype=PRECISIONS[precision])
    nav = Navigator(world, agent, params, tok, max_batch=BATCH, precision=precision, device=device)
    batches = [requests[i:i + BATCH] for i in range(0, len(requests), BATCH)]
    nav.navigate_batch(batches[0])  # first call: kernels loaded, allocator warm
    torch.cuda.synchronize()

    reset_launch_counts()
    latencies, outs = [], []
    for r in range(SERVE_ROUNDS):
        for reqs in batches:
            t0 = time.perf_counter()
            out = nav.navigate_batch(reqs)  # ends in a copy of the records to the host
            latencies.append(time.perf_counter() - t0)
            if r == 0:
                outs += out
    counts = launch_counts()
    calls = SERVE_ROUNDS * len(batches)
    T = agent.episode_len
    check(counts == {"lstm_scan": 2 * calls, "pano_attend": T * calls, "cand_score": T * calls},
          f"launches per call: {counts} over {calls} calls of {T} steps")
    check_trajectories(world, requests, outs, T)

    # the same requests with the plain versions on the card
    ep = nav.episodes(batches[0])
    res_k = nav.rollout(ep)
    with plain_kernels():
        res_p = nav.rollout(ep)
        outs_p = nav.navigate_batch(batches[0])
    l_k, l_p = res_k.steps.logits[0].float(), res_p.steps.logits[0].float()
    live = l_p > -1e29
    check(bool(torch.equal(live, l_k > -1e29)), "the same candidate slots are masked")
    scale = float(l_p[live].abs().max())
    err = float((l_k - l_p)[live].abs().max())
    rel = err / max(scale, 1.0)
    # f32 sums of up to 2176 products, in another order, whose magnitudes
    # add up to some 50 times the result: a relative error near 1e-5
    tol = 1e-4
    check(rel <= tol, f"{precision}: first-step logits |kernel - plain| / scale = {rel:.3g}")
    ties = compare_actions(res_k, res_p, tol * max(scale, 1.0)) if precision == "f32" else None
    if precision == "f32" and ties == 0:
        check(outs_p == outs[:BATCH], "f32 trajectories equal with the plain versions")
    return {"precision": precision, "calls": calls, "launches": counts,
            "latency_s": latencies, "first_step_logit_err": err, "logit_scale": scale,
            "rel_err": rel, "action_ties": ties, "nav": nav, "batches": batches}


def profile_call(nav, reqs):
    """Device time by kernel over one served micro-batch."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nav.navigate_batch(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return wall * 1e3, busy, rows


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    from curriculum_learning_for_vln_torch.ops.cuda import build

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = build.build(ptxas_verbose=True)
    log(f"build: {len(build.SOURCES)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    world, requests, tok, cfg, m, params = build_serving()
    precision = cfg.TPU.PRECISION
    log(f"serving world: {world.num_nodes} nodes x 36 views x {FEAT_DIM}, "
        f"{len(requests)} requests, EnvDrop H={m.HIDDEN_SIZE} E={m.WORD_EMB_SIZE} "
        f"A={m.ACT_EMB_SIZE}, enc len {tok.encoding_length}, episode len "
        f"{cfg.AGENT.MAX_EPISODE_LEN}, precision {precision}, set up in "
        f"{time.perf_counter() - t0:.1f} s")

    from curriculum_learning_for_vln_torch.world.compiler import PRECISIONS

    gen = torch.Generator(device=device).manual_seed(SEED)
    lengths = torch.tensor([tok.encode_sentence(r["instruction"])[1] for r in requests[:BATCH]],
                           device=device)
    log(f"instruction lengths of the first micro-batch: {int(lengths.min())} to "
        f"{int(lengths.max())} tokens of {tok.encoding_length}")
    results = {}
    for prec in ("bf16", "f32"):
        dtype = PRECISIONS[prec]
        features = torch.from_numpy(world.features).to(device).to(dtype)
        for phase in (lambda: lstm_phase(dtype, device, gen, lengths),
                      lambda: pano_phase(dtype, device, gen, features),
                      lambda: cand_phase(dtype, device, gen, features)):
            r = phase()
            torch.cuda.synchronize()
            b_ms, b_by = r.pop("bound")
            r.update(bound_ms=b_ms, bound_by=b_by)
            log(f"{r['name']:12s} {prec:4s} max|kernel-plain| {r['max_abs_err']:.3g} "
                f"(tol {r['tol']}) | kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
                f" ms, bound {b_ms:.4f} ms ({b_by})")
            check(r["max_abs_err"] <= r["tol"], f"{r['name']} {prec} agrees with its plain version")
            results[(r["name"], prec)] = r
        del features

    serve = {}
    for prec in (precision, "f32" if precision != "f32" else "bf16"):
        s = serve_phase(world, requests, tok, m, params, cfg.AGENT.MAX_EPISODE_LEN, prec, device)
        lat = s["latency_s"]
        med = statistics.median(lat)
        log(f"serve {prec}: {s['calls']} calls of {BATCH} requests, latency median "
            f"{med * 1e3:.2f} ms (min {min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f}), "
            f"{BATCH / med:.1f} requests/s | launches {s['launches']} | first-step logits "
            f"|kernel - plain| {s['first_step_logit_err']:.3g} of scale "
            f"{s['logit_scale']:.3g}; f32 action ties {s['action_ties']} | {card}")
        serve[prec] = s
    counts_main, calls_main = serve[precision]["launches"], serve[precision]["calls"]

    nav = serve[precision]["nav"]
    wall, busy, rows = profile_call(nav, serve[precision]["batches"][0])
    log(f"profile of one {precision} call: wall {wall:.2f} ms under the profiler, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%)" if rows
        else "profile: the profiler shows no device time")
    for dev_ms, count, key in rows[:12]:
        log(f"  {dev_ms:9.3f} ms {count:6d}x  {key[:90]}")

    sources = {"lstm_scan": ("csrc/lstm_scan.cu", "ops/pallas/lstm_scan.py:76"),
               "pano_attend": ("csrc/pano_fused.cu", "ops/pallas/pano_fused.py:224"),
               "cand_score": ("csrc/cand_score.cu", "ops/pallas/cand_score.py:113")}
    kernels = []
    for name in KERNEL_NAMES:
        r, r32 = results[(name, precision)], results[(name, "f32")]
        src, tpu = sources[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"curriculum_learning_for_vln_torch/{src}",
            "replaces": f"curriculum_learning_for_vln_tpu/{tpu}",
            "launches": counts_main[name], "main_path_calls": calls_main,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "dtype": precision, "tol": r["tol"],
            "library_call": r["library_call"], "check": "ok",
            "f32": {k: r32[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
