#!/usr/bin/env python3
"""Sweep the tile shapes of the port's dense, ELL and block-CSR kernels on one GPU.

    python3 tools/torch_tile_sweep.py [KERNEL ...]   # from the repository root, on a CUDA host

KERNEL is ``semiring_matmul``, ``bsr_spmm`` or ``bcsr_spmm`` (default:
all three). For each candidate pair of tiles the script rewrites the
``using Wide = Tile<...>;`` and ``using Narrow = Tile<...>;`` lines of a
copy of ``src/repro_torch/csrc/<KERNEL>.cu`` (into the git-ignored
``src/repro_torch/_build/sweep``), builds every copy at once (one nvcc
each, with the package's flags) and reports the spilled bytes of each
instantiation. It checks each copy against the plain PyTorch version and
times it with CUDA events: the dense kernel at 1024 × 1024 × 512 on a
densified RadiX-net stride-32 layer, the ELL kernel on that layer with a
512-column panel, in all eight semirings (wide tile), and both on an
8-column panel (narrow tile); one ``torch.addmm`` of the wide product
(TF32 off) is the yardstick. The block-CSR kernel runs on the graphblas
phase's skewed 8192 × 8192 adjacency (``random_skewed`` seed 5, 8192
stored blocks, skew 0.8) at 256 columns in all eight semirings (wide)
and at 8 columns (narrow), once per piece length S in ``SLOTS`` (the
launcher's piece table, rebuilt for each S; ``PIECE_SLOTS`` is the
shipped one), beside the ``addmm`` of the adjacency's dense form. Prints
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
CSR_WIDE = ((128, 4, 4, 3), (64, 4, 4, 3), (128, 4, 4, 4))  # CN, TM, TN, STAGES
CSR_NARROW = ((8, 1, 1, 4), (8, 2, 1, 4))
SLOTS = (32, 64, 128)  # piece lengths S of the block-CSR launch
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
    from repro_torch.kernels import bcsr_spmm as kbcsr
    from repro_torch.kernels import bsr_spmm as kbsr
    from repro_torch.kernels import semiring_matmul as ksmm
    from repro_torch.kernels.semirings import kernel_semiring
    from repro_torch.sparse import BlockCSRMatrix

    kernels = sys.argv[1:] or ["semiring_matmul", "bsr_spmm", "bcsr_spmm"]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    weights, biases = rx.radixnet_weights(rx.RadixNetSpec(1024, 2), device=dev)
    ell, bias = weights[1], biases[0]
    dense = ell.to_dense()
    n = 512
    y = torch.from_numpy(np.random.default_rng(0).random((1024, n), dtype=np.float32)).to(dev)
    csr = BlockCSRMatrix.random_skewed(5, (8192, 8192), (16, 16), 8192, skew=0.8, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    csr_y = torch.rand((8192, 256), generator=g, device=dev)
    csr_bias = torch.randn((8192,), generator=g, device=dev)
    out = torch.empty((8192 * 256,), device=dev)  # reused by every launch
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    p = lambda t: ctypes.c_void_p(0 if t is None else t.data_ptr())  # noqa: E731
    bias_col = bias[:, None]
    print(json.dumps({"addmm_ms": gpu_time_ms(lambda: torch.addmm(bias_col, dense, y),
                                              per_rep=20, reps=5),
                      "shape": [1024, 1024, n]}), flush=True)
    if "bcsr_spmm" in kernels:
        csr_dense = csr.to_dense()
        print(json.dumps({"addmm_ms": {w: gpu_time_ms(
            lambda: torch.addmm(csr_bias[:, None], csr_dense, csr_y[:, :w]), per_rep=5, reps=5)
            for w in (256, 8)}, "shape": [8192, 8192, "256 | 8"]}), flush=True)
        del csr_dense

    def run_dense(lib, sid, y, cn=None, table=None):
        n = y.shape[1]
        return lib.semiring_matmul_f32(p(dense), p(y), p(bias), p(out), 1024, n, 1024,
                                       int(n <= 16), 1, sid, stream)

    def run_ell(lib, sid, y, cn=None, table=None):
        n = y.shape[1]
        return lib.bsr_spmm_f32(p(ell.blocks), p(ell.col_idx), p(ell.block_mask), p(y), p(bias),
                                p(out), ell.n_row_blocks, ell.max_blocks_per_row, 16, 16, n,
                                int(n <= 16), 1, sid, stream)

    def run_csr(lib, sid, y, cn, table):
        n = y.shape[1]
        tiles = -(-n // cn)
        partials = counters = None  # as the launcher allocates them
        if table.n_cut_rows:
            partials = torch.empty((table.n_cut_pieces, tiles, 16, cn), device=dev)
            counters = torch.zeros((table.n_cut_rows, tiles), dtype=torch.int32, device=dev)
        return lib.bcsr_spmm_f32(p(csr.values), p(csr.col_idx), p(csr.valid), p(table.pieces),
                                 p(table.cuts), table.n_pieces, p(y), p(csr_bias), p(out),
                                 p(partials), p(counters), 16, 16, n, int(n <= 16), 1, sid,
                                 stream)

    wants = {}

    def measure(kernel, lib, run, a, b, panel, names, cn, table=None):
        """Each semiring's check against the plain version and its time."""
        module = {"semiring_matmul": (ksmm, "semiring_matmul_plain"),
                  "bsr_spmm": (kbsr, "bsr_spmm_plain"), "bcsr_spmm": (kbcsr, "bcsr_spmm_plain")}
        plain = getattr(*module[kernel])
        m, w = a.shape[0], panel.shape[1]
        stored = (2.0 * m * a.shape[1] if kernel == "semiring_matmul"
                  else 2.0 * a.nnz_blocks() * 16 * 16)
        res = {}
        for name in names:
            sid = kernel_semiring(name).id
            err = run(lib, sid, panel, cn, table)
            key = (kernel, name, w)
            if key not in wants:
                wants[key] = plain(a, panel, b, semiring_name=name, fuse_bias_relu=True)
            torch.cuda.synchronize()
            if err:
                res[name] = {"launch_error": err}
                continue
            got = out[:m * w].view(m, w)
            tol = (1e-5, 1e-5) if name == "log_plus" else (SPMM_RTOL, SPMM_ATOL)
            ok = bool(torch.allclose(got, wants[key], rtol=tol[0], atol=tol[1], equal_nan=True))
            ms = gpu_time_ms(lambda: run(lib, sid, panel, cn, table), per_rep=20, reps=5)
            res[name] = {"ok": ok, "ms": round(ms, 5), "tflops": round(stored * w / ms / 1e9, 3)}
        return res

    narrow_y = y[:, :8].contiguous()
    csr_narrow_y = csr_y[:, :8].contiguous()
    cases = {  # kernel: (tile candidates, module, runner, matrix, bias, panels)
        "semiring_matmul": (variants(DENSE_WIDE, DENSE_NARROW), ksmm, run_dense, dense, bias,
                            ((y, SEMIRINGS, "n512"), (narrow_y, NARROW_SEMIRINGS, "n8"))),
        "bsr_spmm": (variants(ELL_WIDE, ELL_NARROW), kbsr, run_ell, ell, bias,
                     ((y, SEMIRINGS, "n512"), (narrow_y, NARROW_SEMIRINGS, "n8"))),
        "bcsr_spmm": (variants(CSR_WIDE, CSR_NARROW), kbcsr, run_csr, csr, csr_bias,
                      ((csr_y, SEMIRINGS, "n256"), (csr_narrow_y, NARROW_SEMIRINGS, "n8"))),
    }
    tables = {slots: kbcsr.piece_table(csr, slots) for slots in SLOTS}
    for kernel in kernels:
        pairs, module, run, a, b, panels = cases[kernel]
        for (wide, narrow), (path, spill, log) in build_variants(kernel, pairs).items():
            row = {"kernel": kernel, "wide": list(wide), "narrow": list(narrow), "spills": spill}
            if path is None:
                row["build_error"] = log[-2000:]
                print(json.dumps(row), flush=True)
                continue
            lib = load(path, module.SIGNATURES)
            for slots in SLOTS if kernel == "bcsr_spmm" else (None,):
                if slots is not None:
                    t = tables[slots]
                    row = {**row, "slots": slots, "pieces": t.n_pieces,
                           "cut_rows": t.n_cut_rows, "cut_pieces": t.n_cut_pieces}
                for panel, names, key in panels:
                    cn = (wide if panel.shape[1] > 16 else narrow)[0]
                    row[key] = measure(kernel, lib, run, a, b, panel, names, cn,
                                       tables.get(slots))
                print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
