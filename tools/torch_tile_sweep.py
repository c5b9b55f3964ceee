#!/usr/bin/env python3
"""Sweep the tile shapes of the port's dense and ELL kernels on one GPU.

    python3 tools/torch_tile_sweep.py        # from the repository root, on a CUDA host

For each candidate pair of tiles the script rewrites the ``using Wide =
Tile<...>;`` and ``using Narrow = Tile<...>;`` lines of a copy of
``src/repro_torch/csrc/semiring_matmul.cu`` or ``bsr_spmm.cu`` (into the
git-ignored ``src/repro_torch/_build/sweep``), builds every copy at once
(one nvcc each, with the package's flags) and reports the spilled bytes
of each instantiation. It checks each copy against the plain PyTorch
version and times it with CUDA events at the serving shapes: the dense
kernel at 1024 × 1024 × 512 on a densified RadiX-net stride-32 layer,
the ELL kernel on that layer with a 512-column panel, in all eight
semirings (wide tile), and both on an 8-column panel (narrow tile); one
``torch.addmm`` of the wide product (TF32 off) is the yardstick. Prints
one JSON line per candidate, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from chip_smoke import gpu_time_ms  # noqa: E402  (the same timing as the smoke run)

DENSE_WIDE = (  # BM, BN, BK, TM, TN, STAGES; the first is the source's own
    (64, 64, 32, 4, 4, 2), (64, 64, 32, 4, 4, 3), (64, 64, 16, 4, 4, 3),
    (32, 128, 32, 4, 4, 2),
)
DENSE_NARROW = ((16, 8, 32, 1, 1, 3), (32, 8, 32, 2, 1, 3))
ELL_WIDE = (  # CN, TM, TN, STAGES
    (128, 4, 4, 3), (128, 2, 4, 3), (256, 4, 4, 3), (64, 4, 4, 3),
)
ELL_NARROW = ((8, 1, 1, 4), (8, 2, 1, 4))
SEMIRINGS = ("plus_times", "max_plus", "min_plus", "max_min", "min_max", "lor_land",
             "xor_and", "log_plus")
NARROW_SEMIRINGS = ("plus_times", "xor_and", "log_plus")
SPMM_RTOL, SPMM_ATOL = 1e-5, 1e-6


def variants(wide, narrow):
    """(wide, narrow) pairs: every wide tile with the first narrow one,
    then the first wide tile with every other narrow one."""
    return [(w, narrow[0]) for w in wide] + [(wide[0], t) for t in narrow[1:]]


def spills(log: str) -> dict:
    """Spilled bytes of each instantiation (semiring, tile) in a ptxas log."""
    out, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            sr = re.search(r"N8semiring\d+([A-Za-z]+)E", entry.group(1))
            tile = re.search(r"TileI((?:Li\d+E)+)", entry.group(1))
            current = (sr.group(1) if sr else "?") + str(
                [int(v) for v in re.findall(r"Li(\d+)E", tile.group(1))] if tile else [])
        found = re.search(r"(\d+) bytes spill stores", line)
        if found and current and int(found.group(1)):
            out[current] = int(found.group(1))
    return out


def build_variants(kernel: str, pairs) -> dict:
    """Library path, spills and log of each (wide, narrow) copy of
    csrc/<kernel>.cu, all built at once."""
    from repro_torch.kernels import build

    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC_DIR / f"{kernel}.cu").read_text()
    procs = {}
    for wide, narrow in pairs:
        tag = "_".join(map(str, wide + narrow))
        new = text
        for name, tile in (("Wide", wide), ("Narrow", narrow)):
            new, count = re.subn(rf"using {name} = Tile<[\d, ]+>;",
                                 f"using {name} = Tile<{', '.join(map(str, tile))}>;", new)
            assert count == 1, (kernel, name)
        src = out_dir / f"{kernel}_{tag}.cu"
        src.write_text(new)
        lib = src.with_suffix(".so")
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o", str(lib), str(src)]
        procs[(wide, narrow)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for pair, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=900)
        libs[pair] = (lib if proc.returncode == 0 else None, spills(log), log)
    return libs


def load(path, signatures):
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_tile_sweep.py: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import bsr_spmm as kbsr
    from repro_torch.kernels import semiring_matmul as ksmm
    from repro_torch.kernels.semirings import kernel_semiring

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    weights, biases = rx.radixnet_weights(rx.RadixNetSpec(1024, 2), device=dev)
    ell, bias = weights[1], biases[0]
    dense = ell.to_dense()
    n = 512
    y = torch.from_numpy(np.random.default_rng(0).random((1024, n), dtype=np.float32)).to(dev)
    out = torch.empty((1024, n), device=dev)  # reused: a narrow launch fills (1024, 8)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    bias_col = bias[:, None]
    addmm_ms = gpu_time_ms(lambda: torch.addmm(bias_col, dense, y), per_rep=20, reps=5)
    stored = ell.nnz_blocks() * 16 * 16 * n * 2
    work = {"semiring_matmul": 2.0 * 1024 * 1024 * n, "bsr_spmm": float(stored)}

    def run_dense(lib, sid, y):
        n = y.shape[1]
        return lib.semiring_matmul_f32(p(dense), p(y), p(bias), p(out), 1024, n, 1024,
                                       int(n <= 16), 1, sid, stream)

    def run_ell(lib, sid, y):
        n = y.shape[1]
        return lib.bsr_spmm_f32(p(ell.blocks), p(ell.col_idx), p(ell.block_mask), p(y), p(bias),
                                p(out), ell.n_row_blocks, ell.max_blocks_per_row, 16, 16, n,
                                int(n <= 16), 1, sid, stream)

    narrow_y = y[:, :8].contiguous()
    print(json.dumps({"addmm_ms": addmm_ms, "shape": [1024, 1024, n]}), flush=True)
    for kernel, pairs, module, run, a in (
        ("semiring_matmul", variants(DENSE_WIDE, DENSE_NARROW), ksmm, run_dense, dense),
        ("bsr_spmm", variants(ELL_WIDE, ELL_NARROW), kbsr, run_ell, ell),
    ):
        plain = ksmm.semiring_matmul_plain if kernel == "semiring_matmul" else kbsr.bsr_spmm_plain
        for (wide, narrow), (path, spill, log) in build_variants(kernel, pairs).items():
            row = {"kernel": kernel, "wide": list(wide), "narrow": list(narrow), "spills": spill}
            if path is None:
                row["build_error"] = log[-2000:]
                print(json.dumps(row), flush=True)
                continue
            lib = load(path, module.SIGNATURES)
            for panel, names, key in ((y, SEMIRINGS, "n512"), (narrow_y, NARROW_SEMIRINGS, "n8")):
                res = row[key] = {}
                for name in names:
                    sid = kernel_semiring(name).id
                    err = run(lib, sid, panel)
                    want = plain(a, panel, bias, semiring_name=name, fuse_bias_relu=True)
                    torch.cuda.synchronize()
                    if err:
                        res[name] = {"launch_error": err}
                        continue
                    got = out.view(-1)[:out.shape[0] * panel.shape[1]].view(out.shape[0], -1)
                    tol = (1e-5, 1e-5) if name == "log_plus" else (SPMM_RTOL, SPMM_ATOL)
                    ok = bool(torch.allclose(got, want, rtol=tol[0], atol=tol[1], equal_nan=True))
                    ms = gpu_time_ms(lambda: run(lib, sid, panel), per_rep=20, reps=5)
                    res[name] = {"ok": ok, "ms": round(ms, 5),
                                 "tflops": round(work[kernel] * panel.shape[1] / n / ms / 1e9, 3)}
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
