#!/usr/bin/env python3
"""Sweep the tiles and stages of the port's two fused kernels on one GPU.

    python3 tools/torch_fused_sweep.py       # from the repository root, on a CUDA host

For each candidate the script rewrites ``constexpr int kStages``, ``using
Resident = Tile<...>;`` and ``using Tiled = Tile<...>;`` in a copy of
``src/repro_torch/csrc/fused_mlp.cu`` (into the git-ignored
``src/repro_torch/_build/sweep``), builds every copy at once (one nvcc
each, with the package's flags) and reports the spilled bytes of each
copy. It launches each copy through its C entries, with the launch the
port would choose for it (resident clusters from the card's SMs and the
clusters of each size it holds at once; the tiled cooperative grid from
the CTAs an SM holds), checks the result against the plain PyTorch
version (max |Δ| ≤ 1e-4 · max |plain|) and times it with CUDA events:
the resident kernel on RadiX-net 1024 × 120 at 512 and 2048 columns, the
tiled kernel on 16384 × 120 and 1024 × 120 at 512 columns. Prints one
JSON line per candidate (the first is the source's own), with the
clusters of 1, 2, 4 and 8 resident CTAs the card holds at once, then the
card's name and power limit.
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

CANDIDATES = (  # (resident CN, TN), (tiled CN, TN), stages
    ((8, 2), (32, 4), 3), ((8, 2), (32, 4), 4), ((8, 2), (32, 4), 2),
    ((16, 2), (16, 2), 3), ((8, 1), (32, 4), 3),
)
STACK_RTOL = 1e-4


def build_candidates() -> dict:
    """Library path (None when the build failed), spilled bytes and log of
    each candidate's copy of csrc/fused_mlp.cu, all built at once."""
    from repro_torch.kernels import build

    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC_DIR / "fused_mlp.cu").read_text()
    procs = {}
    for cand in CANDIDATES:
        (rcn, rtn), (tcn, ttn), stages = cand
        new = text
        for pattern, repl in (
            (r"constexpr int kStages = \d+;", f"constexpr int kStages = {stages};"),
            (r"using Resident = Tile<\d+, \d+, false>;",
             f"using Resident = Tile<{rcn}, {rtn}, false>;"),
            (r"using Tiled = Tile<\d+, \d+, true>;", f"using Tiled = Tile<{tcn}, {ttn}, true>;"),
        ):
            new, count = re.subn(pattern, repl, new)
            assert count == 1, pattern
        src = out_dir / f"fused_mlp_{rcn}_{rtn}_{tcn}_{ttn}_{stages}.cu"
        src.write_text(new)
        lib = src.with_suffix(".so")
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o", str(lib), str(src)]
        procs[cand] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    out = {}
    for cand, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=900)
        spilled = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores", log))
        out[cand] = (lib if proc.returncode == 0 else None, spilled, log)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_fused_sweep.py: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core.dnn import stack_bsr
    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import fused_mlp as kf

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731

    def stack(neurons, n, density):
        w, b = rx.radixnet_weights(rx.RadixNetSpec(neurons, 120), device=dev)
        sw, sb = stack_bsr(w), torch.stack(b)
        y0 = torch.from_numpy(np.ascontiguousarray(
            rx.radixnet_input_panel(neurons, n, density=density, seed=0))).to(dev)
        return sw, sb, y0, kf.fused_mlp_plain(sw, sb, y0)

    cases = {  # name: (tiled, stack)
        "resident_1024x120x512": (False, stack(1024, 512, 0.3)),
        "resident_1024x120x2048": (False, stack(1024, 2048, 0.3)),
        "tiled_16384x120x512": (True, stack(16384, 512, 0.4)),
        "tiled_1024x120x512": (True, stack(1024, 512, 0.3)),
    }

    def occupancy(lib, tiled, nrb, cluster):
        result = ctypes.c_int(0)
        err = lib.fused_mlp_occupancy(int(tiled), nrb, 16, 0, cluster, ctypes.byref(result))
        return result.value if err == 0 else 0

    for cand, (path, spilled, log) in build_candidates().items():
        rcn = cand[0][0]
        row = {"resident_tile": list(cand[0]), "tiled_tile": list(cand[1]), "stages": cand[2],
               "spilled_bytes": spilled}
        if path is None:
            row["build_error"] = log[-2000:]
            print(json.dumps(row), flush=True)
            continue
        lib = ctypes.CDLL(str(path))
        for name, argtypes in kf.SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        # clusters of each size the card holds at once at this copy's resident CTA
        row["clusters_at_once"] = {c: occupancy(lib, False, 64, c) for c in (1, 2, 4, 8)}
        for case, (tiled, (sw, sb, y0, want)) in cases.items():
            n_layers, nrb, mbpr = sw.col_idx.shape
            m, n = y0.shape
            out = torch.empty((m, n), device=dev)
            head = (p(sw.blocks), p(sw.col_idx), p(sw.block_mask), p(y0), p(sb), p(out))
            shape = (n_layers, nrb, mbpr, 16, n, 0)
            if tiled:
                scratch = torch.empty((2, m, n), device=dev)
                geometry = {"ctas": sms * occupancy(lib, True, nrb, 1)}
                launch = lambda: lib.fused_mlp_tiled(  # noqa: E731
                    *head, p(scratch), *shape, geometry["ctas"], stream)
            else:
                stripes = n // rcn
                c = kf.cluster_size(stripes, nrb, sms,
                                    lambda c: occupancy(lib, False, nrb, c))
                geometry = {"cluster": c, "ctas": stripes * c}
                launch = lambda: lib.fused_mlp_resident(*head, *shape, c, stream)  # noqa: E731
            err = launch()
            torch.cuda.synchronize()
            if err:
                row[case] = {"launch_error": err, **geometry}
                continue
            ok = float((out - want).abs().max()) <= STACK_RTOL * float(want.abs().max())
            row[case] = {"ok": ok, "ms": gpu_time_ms(launch, per_rep=1, reps=3), **geometry}
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
