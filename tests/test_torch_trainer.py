"""The port's host side of training against the JAX package, and its
trainer and entry point end to end on the CPU.

* ``R2RBatchEnv``: the same batch indices, validity and
  ``cur_batch_max_hops`` as the JAX env over more than an epoch (a
  wraparound reshuffle included), for two seeds, and the same
  exact-coverage evaluation batches;
* ``Evaluation.score``: the same summary as JAX's on a fixed set of
  trajectories (exact: both are the same numpy code);
* ``ClassicTrainer.train`` on a tiny synthetic world with
  ``device="cpu"``: 2 epochs x 2 iterations, a checkpoint that the port's
  ``Navigator`` serves, and ``OUTPUT.RESUME`` from it;
* ``main``: without ``--device`` it refuses to run on this CUDA-less host,
  it refuses the modes and options it does not port, and it takes the
  shipped configs' curriculum modes and packed RL.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch import main as t_main
from curriculum_learning_for_vln_torch import pipeline as t_pipeline
from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
from curriculum_learning_for_vln_torch.engine import evaluator as t_eval
from curriculum_learning_for_vln_torch.engine import trainer as t_trainer
from curriculum_learning_for_vln_torch.engine.checkpoint import load_checkpoint
from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv as TEnv
from curriculum_learning_for_vln_torch.serve import Navigator
from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults as t_cfg
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.data.datasets import expand_r2r_items
from curriculum_learning_for_vln_tpu.engine import evaluator as j_eval
from curriculum_learning_for_vln_tpu.env.host_env import R2RBatchEnv as JEnv

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 10


@pytest.fixture(scope="module")
def host(synth_world, synth_graphs, synth_dataset, tokenizer):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    t_world.features = synth_world.features.copy()
    items = expand_r2r_items(synth_dataset, tokenizer)  # 3 instructions per path
    return synth_world, t_world, items


@pytest.mark.parametrize("seed", [0, 5])
def test_batch_order_matches_jax(host, seed):
    j_world, t_world, items = host
    je = JEnv(j_world, items, B, seed=seed)
    te = TEnv(t_world, items, B, seed=seed, device="cpu")
    n_batches = 2 * len(items) // B + 3  # two epochs and a bit: reshuffles on wrap
    for _ in range(n_batches):
        jb, tb = je.next_batch(), te.next_batch()
        np.testing.assert_array_equal(te.cur_batch_index, je.cur_batch_index)
        assert te.cur_batch_max_hops == je.cur_batch_max_hops
        for name in ("instr_tokens", "instr_len", "start_node", "start_heading", "goal",
                     "goal_local", "item_idx", "valid"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          np.asarray(getattr(jb, name)), err_msg=name)
    for jb, tb in zip(je.eval_batches(), te.eval_batches(), strict=True):
        np.testing.assert_array_equal(tb.item_idx.numpy(), np.asarray(jb.item_idx))
        np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))


def test_evaluation_score_matches_jax(host):
    j_world, t_world, items = host
    rng = np.random.default_rng(3)
    results = []
    for it in items:
        path = [it["path"][0]]
        for _ in range(int(rng.integers(0, 5))):  # a random walk on the graph
            g = t_world.global_id(it["scan"], path[-1])
            nbrs = t_world.cand_next[g][t_world.cand_valid[g]]
            if len(nbrs) == 0:
                break
            path.append(t_world.viewpoint_of(int(rng.choice(nbrs))))
        if rng.random() < 0.3:
            path = list(it["path"])  # some succeed
        results.append({"instr_id": it["instr_id"],
                        "trajectory": [(vp, 0.0, 0.0) for vp in path]})
    gt = t_trainer.dedup_by_path(items)
    want, _ = j_eval.Evaluation(j_world, gt).score(results)
    got, _ = t_eval.Evaluation(t_world, gt).score(results)
    assert got == want
    assert 0.0 < got["success_rate"] < 1.0


def _tiny_cfg(tmp_path):
    cfg = t_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs/envdrop/envdrop_config.yaml"))
    cfg.merge_from_list([
        "TPU.PACKED_RL", 0, "TPU.SYNTHETIC_WORLD", True, "TPU.SYNTHETIC_SCANS", 3,
        "TPU.SYNTHETIC_NODES", 24, "TPU.SYNTHETIC_TRAIN_PATHS", 20, "TPU.SYNTHETIC_VAL_PATHS", 6,
        "TRAIN.MAX_EPOCH", 2, "TRAIN.ITER_PER_EPOCH", 2, "TRAIN.BATCH_SIZE", 8,
        "TRAIN.EVAL_INTERVAL", 1, "AGENT.MAX_EPISODE_LEN", 6, "DATA.MAX_ENC_LEN", 16,
        "MODEL.ENVDROP.HIDDEN_SIZE", 64, "MODEL.ENVDROP.WORD_EMB_SIZE", 32,
        "MODEL.ENVDROP.ACT_EMB_SIZE", 16, "OUTPUT.CKPT_DIR", str(tmp_path / "ckpt"),
        "OUTPUT.TSBOARD_DIR", "", "OUTPUT.LOG_DIR", ""])
    return cfg


def test_classic_trainer_trains_and_serves(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    tok = t_pipeline.build_tokenizer(cfg)
    world, train_env, valid_env, feat_dim = t_pipeline.build_environments(cfg, tok, seed=3,
                                                                          device="cpu")
    agent = EnvDropAgent(cfg.MODEL.ENVDROP, cfg.DATA.MAX_ENC_LEN, tok.vocab_size(), feat_dim,
                         cfg.AGENT.MAX_EPISODE_LEN, obs_masks=cfg.TPU.OBS_MASKS,
                         compute_dtype=torch.bfloat16)
    assert cfg.TPU.PRECISION == "bf16" and cfg.TPU.OBS_MASKS == "prng"
    params, best = t_trainer.ClassicTrainer().train(cfg, agent, "", train_env, valid_env,
                                                    seed=3, device="cpu")
    assert set(best) == {"val_seen", "val_unseen"}
    latest = tmp_path / "ckpt" / "latest.ckpt"
    bundle = load_checkpoint(str(latest))
    assert bundle["epoch"] == 2 and bundle["opt_state"]["state"]
    nav = Navigator.from_checkpoint(world, agent, str(latest), tok, max_batch=4,
                                    precision="bf16", device="cpu")
    for got, want in zip(nav.params["decoder"]["lstm"].values(),
                         params["decoder"]["lstm"].values()):
        assert torch.equal(got, want.detach().to(torch.bfloat16))
    item = valid_env["val_unseen"].data[0]
    out = nav.navigate(item["instructions"], item["scan"], item["path"][0], item["heading"])
    assert out["trajectory"][0][0] == item["path"][0]

    # OUTPUT.RESUME: the epoch after the checkpoint's, with its state
    cfg.merge_from_list(["OUTPUT.RESUME", "latest", "TRAIN.MAX_EPOCH", 3])
    params3, _ = t_trainer.ClassicTrainer().train(cfg, agent, "", train_env, valid_env,
                                                  seed=3, device="cpu")
    assert load_checkpoint(str(latest))["epoch"] == 3
    assert not torch.equal(params3["critic"]["fc1"]["w"], params["critic"]["fc1"]["w"])


def test_main_defaults_to_cuda_and_refuses_what_it_does_not_port():
    if not torch.cuda.is_available():  # on a GPU host main would train
        cmd = [sys.executable, "-m", "curriculum_learning_for_vln_torch.main", "--config-file",
               "configs/envdrop/envdrop_config.yaml", "TPU.PACKED_RL", "0"]
        run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120)
        assert run.returncode != 0 and "CUDA is not available" in run.stderr
    t_main.check_ported(*t_main.parse_args(["--device", "cpu", "--self-train"]))  # ported
    for extra, what in ((["--beam", "3"], "--beam"),
                        (["DATA.NAME", "CLR2R", "TRAIN.CLMODE", "AUTO"], "curriculum"),
                        (["TRAIN.EVAL_TRAIN", "True"], "EVAL_TRAIN"),
                        (["TPU.SCAN_EARLY_EXIT", "True"], "SCAN_EARLY_EXIT"),
                        (["TPU.FUSED_BPTT", "True"], "FUSED_BPTT")):
        args, cfg = t_main.parse_args(["--device", "cpu", *extra])
        with pytest.raises(NotImplementedError, match=what):
            t_main.check_ported(args, cfg)
    # the curriculum trainers and packed RL, as the configs ship them, run
    for config, extra in (("envdrop_config.yaml", []), ("envdrop_cl_config.yaml", []),
                          ("envdrop_cl_config.yaml", ["TRAIN.CLMODE", "SELF-PACE",
                                                      "TPU.OBS_MASKS", "prng_shared"])):
        args, cfg = t_main.parse_args(["--device", "cpu", "--config-file",
                                       os.path.join(REPO, "configs/envdrop", config), *extra])
        assert cfg.TPU.PACKED_RL == 3
        t_main.check_ported(args, cfg)
