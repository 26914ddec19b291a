#!/usr/bin/env python3
"""Learning check of the PyTorch port on one GPU: the verify recipe (a
grounded synthetic world of 6 scans x 48 nodes, B = 32, T = 15, 30 epochs
x 20 iterations, evaluation at epochs 15 and 30) through
``python -m curriculum_learning_for_vln_torch.main``, with the configs as
shipped (``TPU.PACKED_RL 3``):

    python3 scripts/torch_learning_check.py [--out DIR] [RUN ...]

RUN names one of the runs below (default: the first four, EnvDrop's,
in this order; ``follower`` and ``monitor`` name the Follower's and the
Self-Monitor's classic, NAIVE and SPCL runs at seed 7, at the recipe of
the JAX package's parity matrix, ``AGENT_RECIPE``).  Each run's output goes to ``DIR/<run>.log`` (default
``build/learning_check_logs``) and its checkpoints under
``build/learning_check/<run>``; the script prints one line per run with
its val_unseen success rate at each evaluation, then the card's name and
power limit, then one JSON object of each run's final and best rates (the
JAX matrix reports the best).  It exits non-zero
if a run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

RECIPE = ["TPU.SYNTHETIC_WORLD", "True", "TPU.SYNTHETIC_SCANS", "6", "TPU.SYNTHETIC_NODES", "48",
          "TRAIN.MAX_EPOCH", "30", "TRAIN.ITER_PER_EPOCH", "20", "TRAIN.BATCH_SIZE", "32",
          "TRAIN.EVAL_INTERVAL", "15", "AGENT.MAX_EPISODE_LEN", "15", "DATA.MAX_ENC_LEN", "40",
          "OUTPUT.TSBOARD_DIR", ""]
CL, CLASSIC = "configs/envdrop/envdrop_cl_config.yaml", "configs/envdrop/envdrop_config.yaml"
RUNS = {  # name -> (config, seed, extra overrides[, recipe: RECIPE when absent])
    "spcl_seed7": (CL, 7, ["TRAIN.CLMODE", "SELF-PACE"]),
    "spcl_seed0": (CL, 0, ["TRAIN.CLMODE", "SELF-PACE"]),
    "naive_seed7": (CL, 7, ["TRAIN.CLMODE", "NAIVE"]),
    "classic_seed7": (CLASSIC, 7, []),
    # NAIVE switches rounds every 20 epochs: 90 epochs reach all five
    "naive_seed7_90ep": (CL, 7, ["TRAIN.CLMODE", "NAIVE", "TRAIN.MAX_EPOCH", "90"]),
}
# The Follower and the Self-Monitor at the recipe of the JAX package's
# statistical-parity matrix (scripts/parity_matrix.py::make_cfg), whose
# figures are the yardstick: the same world, B = 32, 20 iterations an
# epoch, T = 10, 32 tokens, narrow widths, Adam at 1e-3 (the configs ship
# 1e-4, under which 30 epochs hardly move these agents), the matrix's SPCL
# parameters; 50 epochs for the Follower (BASELINE.md's means), 120 for the
# Self-Monitor (snapshots/matrix_r5_monitor.jsonl), NAIVE switching every
# 20 epochs (the matrix's 120-epoch schedule; its 50-epoch one switched
# every 10).
AGENT_RECIPE = ["TPU.SYNTHETIC_WORLD", "True", "TPU.SYNTHETIC_SCANS", "6",
                "TPU.SYNTHETIC_NODES", "48", "TRAIN.ITER_PER_EPOCH", "20",
                "TRAIN.BATCH_SIZE", "32", "AGENT.MAX_EPISODE_LEN", "10", "DATA.MAX_ENC_LEN", "32",
                "AGENT.FEEDBACK", "sample", "TRAIN.OPTIM", "adam", "TRAIN.LR", "0.001",
                "MODEL.FOLLOWER.WORD_EMB_SIZE", "64", "MODEL.FOLLOWER.HIDDEN_SIZE", "128",
                "MODEL.FOLLOWER.ENC_LAYERS", "1", "MODEL.MONITOR.WORD_EMB_SIZE", "64",
                "MODEL.MONITOR.HIDDEN_SIZE", "128", "MODEL.MONITOR.MLP_HIDDEN", "(64, 128)",
                "TRAIN.SELF_PACE.CRATE", "1.0", "TRAIN.SELF_PACE.LAMB", "2.0",
                "TRAIN.SELF_PACE.MIU", "1.0", "TRAIN.SELF_PACE.WCTRL", "0.5",
                "TRAIN.SELF_PACE.INTERVAL", "2", "OUTPUT.TSBOARD_DIR", ""]
GROUPS = {}
for _agent, _stem, _epochs in (("follower", "follower/follower", 50),
                               ("monitor", "monitor/selfmonitor", 120)):
    _budget = ["TRAIN.MAX_EPOCH", str(_epochs), "TRAIN.EVAL_INTERVAL", str(max(2, _epochs // 5)),
               "TRAIN.SELF_PACE.BURN_IN", str(max(2, _epochs // 4))]
    for _mode, _config, _clmode in (("classic", "_config", []),
                                    ("naive", "_cl_config", ["TRAIN.CLMODE", "NAIVE"]),
                                    ("spcl", "_cl_config", ["TRAIN.CLMODE", "SELF-PACE"])):
        RUNS[f"{_agent}_{_mode}_seed7"] = (f"configs/{_stem}{_config}.yaml", 7,
                                           _budget + _clmode, AGENT_RECIPE)
    GROUPS[_agent] = tuple(f"{_agent}_{m}_seed7" for m in ("classic", "naive", "spcl"))
DEFAULT_RUNS = ("spcl_seed7", "spcl_seed0", "naive_seed7", "classic_seed7")
ROW = re.compile(r"^\|\s*val_unseen\s*\|(.*)\|\s*$")


def val_unseen_sr(text: str):
    """The SR column of every val_unseen row of the score tables."""
    return [float(row.group(1).split("|")[2]) for row in map(ROW.match, text.splitlines()) if row]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/learning_check_logs")
    parser.add_argument("runs", nargs="*", metavar="RUN",
                        help=f"of {list(RUNS)}, or a group of {list(GROUPS)}")
    args = parser.parse_args()
    runs = [r for name in args.runs for r in GROUPS.get(name, (name,))] or DEFAULT_RUNS
    unknown = set(runs) - set(RUNS)
    if unknown:
        parser.error(f"unknown runs {sorted(unknown)}")
    os.makedirs(args.out, exist_ok=True)
    final = {}
    for name in runs:
        config, seed, extra, *recipe = RUNS[name]
        cmd = [sys.executable, "-m", "curriculum_learning_for_vln_torch.main", "--config-file",
               config, "--seed", str(seed), *(recipe[0] if recipe else RECIPE), *extra,
               "OUTPUT.CKPT_DIR", os.path.join("build", "learning_check", name),
               "OUTPUT.LOG_DIR", os.path.join(args.out, name)]
        print("$ " + " ".join(c if c else '""' for c in cmd[1:]), flush=True)
        run = subprocess.run(cmd, capture_output=True, text=True)
        with open(os.path.join(args.out, f"{name}.log"), "w") as f:
            f.write(run.stdout + run.stderr)
        srs = val_unseen_sr(run.stdout)
        print(f"{name}: exit {run.returncode}, val_unseen SR by evaluation {srs}", flush=True)
        if run.returncode or not srs:
            print(run.stdout[-3000:] + run.stderr[-3000:], file=sys.stderr)
            return 1
        final[name] = {"final": srs[-1], "best": max(srs)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print(json.dumps({"val_unseen_sr": final}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
