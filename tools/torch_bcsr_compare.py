#!/usr/bin/env python3
"""Time one tree's block-CSR and ELL SpMM wrappers on the matrices where
``bcsr_spmm`` works, on one GPU, so two trees can be compared in one call.

    python3 tools/torch_bcsr_compare.py [SRC]   # from the repository root, on a CUDA host

SRC is the ``src`` directory whose ``repro_torch`` is timed (default: this
checkout's); run it for a parent tree and for a change in turns (parent,
change, change, parent) inside one chip call. The timing and the bound are
``chip_smoke.py``'s. Matrices, all block 16 with the fused epilogue:

* ``stride1``: RadiX-net 1024's stride-1 layer as block-CSR (2 stored
  blocks a block-row), at 512 and 8 columns;
* ``stride32``: the stride-32 layer as block-CSR (32 a block-row, 2048 in
  all), at 512 and 8 columns;
* ``skewed``: the graphblas phase's adjacency (``random_skewed`` seed 5,
  8192 × 8192, 8192 stored blocks, skew 0.8), at 256 and 8 columns.

Each line gives the kernel's time, its error against the plain version,
the bound and the ``addmm`` of the dense form; ``bsr_spmm`` runs on the
stride-32 layer as ELL at 512 columns, with a SHA-1 of its output, so two
trees' ELL kernels can be held to the same bits. Prints one JSON line per
case, then the card's name and power limit.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]

import chip_smoke as smoke  # noqa: E402  (the timing and bounds of the smoke run)


def main() -> int:
    src = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else os.path.join(ROOT, "src")
    sys.path.insert(0, src)  # ahead of the checkout's src, which chip_smoke added
    import torch

    if not torch.cuda.is_available():
        print("torch_bcsr_compare.py: no CUDA device available", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.kernels.bcsr_spmm import bcsr_spmm_plain
    from repro_torch.sparse import BlockCSRMatrix

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(json.dumps({"src": os.path.dirname(repro_torch.__file__)}), flush=True)
    weights, biases = rx.radixnet_weights(rx.RadixNetSpec(1024, 2), device=dev)
    y = torch.rand((1024, 512), generator=torch.Generator(device=dev).manual_seed(0),
                   device=dev)
    skewed = BlockCSRMatrix.random_skewed(smoke.SKEWED_SEED, (smoke.SKEWED_M,) * 2, (16, 16),
                                          smoke.SKEWED_BLOCKS, skew=smoke.SKEWED_SKEW,
                                          device=dev)
    g = torch.Generator(device=dev).manual_seed(smoke.SKEWED_SEED)
    skew_y = torch.rand((smoke.SKEWED_M, 256), generator=g, device=dev)
    skew_b = torch.randn((smoke.SKEWED_M,), generator=g, device=dev)
    for case, a, dense, panel, b, widths in (
        ("stride1", BlockCSRMatrix.from_bsr(weights[0]), weights[0].to_dense(), y, biases[0],
         (512, 8)),
        ("stride32", BlockCSRMatrix.from_bsr(weights[1]), weights[1].to_dense(), y, biases[0],
         (512, 8)),
        ("skewed", skewed, None, skew_y, skew_b, (256, 8)),
    ):
        dense = a.to_dense() if dense is None else dense
        for w in widths:
            panel_w = panel[:, :w].contiguous()
            row = smoke.panel_timing(ops.bcsr_spmm, bcsr_spmm_plain, a, dense, panel_w, b,
                                     smoke.stored_work(a, w), smoke.spmm_work(a, w))
            print(json.dumps({"kernel": "bcsr_spmm", "case": case, "stored_blocks":
                              a.nnz_blocks(), **row}), flush=True)
        del dense
    ell = weights[1]
    got = ops.bsr_spmm(ell, y, biases[0], fuse_bias_relu=True)
    torch.cuda.synchronize()
    ms = smoke.gpu_time_ms(lambda: ops.bsr_spmm(ell, y, biases[0], fuse_bias_relu=True),
                           per_rep=20, reps=5)
    print(json.dumps({"kernel": "bsr_spmm", "case": "stride32", "n": 512, "ms": ms,
                      "sha1": hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest()}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
