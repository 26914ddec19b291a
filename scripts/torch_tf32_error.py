#!/usr/bin/env python3
"""The error of K2's tensor-core arithmetic at the encoder's shapes, on the
CPU: ``lstm_scan_bwd_emulated`` (TF32 products with the operands the
kernel splits split, in the kernel's order of sums) and the same with no
operand split (plain TF32), each against the plain f32 backward
``lstm_scan_bwd_plain``, beside the tolerances the card tests
(``tests/test_torch_card_kernels.py``) hold the kernel to:

    python3 scripts/torch_tf32_error.py

B = 64, L = 80, D = H = 256, inputs drawn as the card tests draw them
(``tests/torch_card_world.py::lstm_inputs``), token lengths 11-20 and 16-80 (one row at 80), bf16 and
f32.  In bf16 only the walk's product has TF32 operands to split: its
input-side GEMMs multiply bf16 terms, whatever the split.  Prints one
line per (dtype, lengths, arithmetic) with each output's max |error| and
its tolerance, and "ok" or "FAILS".  An arithmetic error measured here,
no device time.
"""
from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from curriculum_learning_for_vln_torch.ops.cuda import lstm_scan as k  # noqa: E402

B, L, D, H = 64, 80, 256, 256


def main() -> int:
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    gen = torch.Generator().manual_seed(0)
    for dtype, rtol_x in ((torch.bfloat16, 8e-3), (torch.float32, 1e-4)):
        for label, lo, hi in (("11-20", 11, 20), ("16-80", 16, 80)):
            lengths = torch.randint(lo, hi + 1, (B,), generator=gen)
            lengths[0] = hi

            def u(*shape):
                return ((torch.rand(*shape, generator=gen) * 2 - 1) / H ** 0.5).to(dtype)

            xs = torch.randn(B, L, D, generator=gen).to(dtype)
            w_ih, w_hh, b = u(D, 4 * H), u(H, 4 * H), u(4 * H)
            d_out = torch.randn(B, L, H, generator=gen)
            dhT, dcT = torch.randn(B, H, generator=gen), torch.randn(B, H, generator=gen)
            _, _, hprev, cprev, gates = k.lstm_scan_train_plain(xs, lengths, w_ih, w_hh, b)
            res = (xs, lengths, w_ih, w_hh, gates, hprev, cprev, d_out, dhT, dcT)
            want = k.lstm_scan_bwd_plain(*res)
            for split in (True, False):
                got = k.lstm_scan_bwd_emulated(*res, split=split)
                parts = []
                ok = True
                for name, g, w, rtol in zip(("d_xs", "dW_ih", "dW_hh", "db"), got, want,
                                            (rtol_x, 1e-4, 1e-4, 1e-4)):
                    err = float((g.float() - w.float()).abs().max())
                    tol = rtol * max(1.0, float(w.float().abs().max()))
                    ok &= err <= tol
                    parts.append(f"{name} {err:.3g} (tol {tol:.3g})")
                what = "split TF32 (the kernel)" if split else "plain TF32"
                print(f"{str(dtype).split('.')[-1]:8s} lengths {label}: {what:23s} "
                      f"{'ok   ' if ok else 'FAILS'} | " + ", ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
