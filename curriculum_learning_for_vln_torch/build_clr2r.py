"""CLR2R construction: pretrain the ViLBERT scorer, score every training
item's path-instruction compatibility, and write the round files.

The port of the JAX package's ``scripts/build_clr2r.py``, with the same
arguments, files and last line.  The reference consumes CLR2R round files
(data/CLR2R/*_v3.json, ref: curriculum_env.py:44-62) but ships no way to
make them; this is the difficulty-scoring pipeline of the paper (§3.1),
end to end on a synthetic grounded world.  Runs on CUDA unless
``--device`` names another device, and raises without a GPU:

    python -m curriculum_learning_for_vln_torch.build_clr2r --out DIR \\
        [--steps 120] [--device cpu] [--mesh-model M] \\
        [--vilbert-config configs/vilbert/bert_base_6layer_6conect.json] [--batch-size 16]

Without ``--vilbert-config`` the scorer is a small one (hidden 64, 2 + 2
layers) over 128-d features; with a published ViLBERT JSON it runs at
that file's widths, over features of its ``v_feature_size`` and region
targets over its ``v_target_size`` classes (the rooms' one-hot).

Writes DIR/R2R_round_{1..5}_v3.json in the reference's round-file format
and prints {"rounds": {...}, "final_loss": x} as its last line.

Several processes, started as ``main``'s are (the VLN_* variables), score
together over a (data, model) mesh of ``--mesh-model`` M ranks a model
group (TPU.MESH_MODEL's counterpart): rank 0 pretrains and broadcasts the
scorer, each batch's rows split over the data axis and the scorer's heads
and FFN columns over the model axis (parallel/vilbert_sharding.py); rank
0 writes the files and prints the line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Build CLR2R round files with a ViLBERT scorer")
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=120, help="pretraining batches")
    ap.add_argument("--scans", type=int, default=4)
    ap.add_argument("--nodes", type=int, default=32)
    ap.add_argument("--paths", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; raises without a GPU)")
    ap.add_argument("--vilbert-config", default=None,
                    help="a ViLBERT JSON (e.g. configs/vilbert/bert_base_6layer_6conect.json); "
                         "default: the small scorer")
    ap.add_argument("--batch-size", type=int, default=16, help="pretraining pairs a step")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="ranks of a model group, over which the scorer's heads split "
                         "(several processes: the VLN_* variables, as main)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    from .parallel import mesh as M
    from .world import compiler

    device = (M.init_from_env(args.device) if M.launched_by_env()
              else compiler.resolve_device(args.device))
    try:
        return build(args, device, M.make_mesh(model=args.mesh_model))
    finally:
        if M.dist.is_initialized():
            M.dist.destroy_process_group()


def build(args, device, mesh) -> dict:
    import numpy as np
    import torch

    from .agents.vln_bert import VLNBertScorer
    from .data.datasets import expand_r2r_items
    from .engine.pretrain import (VLNBertPretrainer, make_clr2r_rounds, pretrain_batches,
                                  score_difficulty)
    from .models.vilbert import VilBertConfig
    from .parallel import mesh as M
    from .utils.tokenizer import Tokenizer, build_vocab
    from .world import compiler, synthetic

    published = VilBertConfig.from_json_file(args.vilbert_config) if args.vilbert_config else None
    feat = published.v_feature_size if published else 128
    max_path = 8
    graphs = synthetic.make_world_graphs(args.scans, args.nodes, seed=args.seed)
    world = compiler.compile_world(graphs, max_candidates=16)
    rooms = synthetic.assign_rooms(world, seed=args.seed)
    synthetic.attach_grounded_features(world, rooms, feature_dim=feat, seed=args.seed)
    items = synthetic.make_grounded_dataset(graphs, world, rooms, num_paths=args.paths,
                                            seed=args.seed + 1)
    tok = Tokenizer(build_vocab(items, min_count=1), encoding_length=24)
    data = expand_r2r_items(items, tok)

    if published and published.vocab_size < tok.vocab_size():
        raise ValueError(f"{args.vilbert_config}: vocab_size {published.vocab_size} < the "
                         f"world's {tok.vocab_size()} words")
    cfg = published or VilBertConfig(
        vocab_size=tok.vocab_size(), hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128, max_position_embeddings=32,
        v_feature_size=feat, v_target_size=len(synthetic.ROOM_TYPES),
        v_hidden_size=64, v_num_hidden_layers=2, v_num_attention_heads=4,
        v_intermediate_size=128, bi_hidden_size=64, bi_num_attention_heads=4,
        v_biattention_id=(0, 1), t_biattention_id=(0, 1))
    if len(data) < args.batch_size:
        raise ValueError(f"--batch-size {args.batch_size} > the {len(data)} instructions")
    # ViLBERT's published pretraining rate at its widths; the small scorer learns faster
    trainer = VLNBertPretrainer(cfg, mask_idx=1, lr=1e-4 if published else 3e-4)
    params, optimizer = trainer.init(torch.Generator().manual_seed(args.seed), device)

    rooms_onehot = torch.eye(cfg.v_target_size, device=device)[torch.from_numpy(rooms).to(device)]

    def batches():
        n = 0
        while n < args.steps:
            for b in pretrain_batches(world, data, tok, batch_size=args.batch_size,
                                      max_path_len=max_path, feat_dim=feat,
                                      node_targets=rooms_onehot, epochs=1, seed=args.seed + n,
                                      device=device):
                yield b
                n += 1
                if n >= args.steps:
                    return

    generator = torch.Generator(device=device).manual_seed(args.seed + 9)
    final = torch.zeros(4, device=device)  # the losses, rank 0's on every rank
    if M.is_main():  # rank 0 pretrains; every rank then scores with its parameters
        params, optimizer, logs = trainer.train(params, optimizer, batches(), generator)
        final = torch.stack([logs[k].detach().float().reshape(())
                             for k in ("loss", "lm_loss", "region_loss", "align_loss")])
        print(f"pretrained {args.steps} steps, final loss {float(final[0]):.4f} (lm "
              f"{float(final[1]):.3f} region {float(final[2]):.3f} align "
              f"{float(final[3]):.3f})", file=sys.stderr)
    M.replicate((params, final))

    scorer = VLNBertScorer(cfg)
    scores = score_difficulty(scorer, params, world, data, tok, max_path_len=max_path,
                              feat_dim=feat, mesh=mesh)
    # one score a path (3 instructions each): the mean; the rounds are
    # path-level partitions of the train split
    by_path = {}
    for it, s in zip(data, scores):
        by_path.setdefault(it["path_id"], []).append(float(s))
    path_scores = np.array([np.mean(by_path[it["path_id"]]) for it in items])
    rounds = make_clr2r_rounds(items, path_scores, n_rounds=5)
    result = {"rounds": {k: len(v) for k, v in rounds.items()}, "final_loss": float(final[0])}
    if not M.is_main():
        return result
    os.makedirs(args.out, exist_ok=True)
    for name, round_items in rounds.items():
        path = os.path.join(args.out, f"R2R_{name}_v3.json")
        with open(path, "w") as f:
            json.dump(round_items, f)
        print(f"wrote {path}: {len(round_items)} paths", file=sys.stderr)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
