#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GraphChallenge serving path on one GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

Phases (each prints one JSON line; any failure raises, exit code != 0):

1. device  — a CUDA card must be present; print its name and power limit,
   build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all at once) and print nvcc's register/spill report.
2. kernels — each of the four kernels against its plain PyTorch version
   at the serving shapes (RadiX-net 1024 neurons, block 16, panel 512;
   16384 neurons for the tiled kernel): error, median time from CUDA
   events, the plain version's time, the bound and (SpMMs) a library
   yardstick.
3. serve   — ``run_challenge(RadixNetSpec(1024, 120))``: all 60 000
   inputs in 512-column panels through ``SparseDNNEngine`` on route
   ``fused``; categories against the numpy reference on 512 inputs.
4. layered — the same spec with ``use_resident=False`` on 2 048 inputs:
   route ``layered`` through both SpMM kernels.
5. tiled   — ``RadixNetSpec(16384, 120)`` on 1 024 inputs at input
   density 0.4: route ``fused-tiled``.

Launch counts are reset to 0 right before each of phases 3-5 and read
right after. The ``kernels`` line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}`` close the run. Numbers are this run's
own; the bound of a kernel is max(bytes / 3.35 TB/s, flops / 67 TFLOP/s)
(H100 SXM HBM3 rate and f32 CUDA-core peak at 700 W), counting the
stored blocks' values, the index arrays, bias, the panel read once and
the output written once, and 2·n flops per nonzero weight (the zeros
inside stored blocks are not work these inputs need).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
SPMM_RTOL, SPMM_ATOL = 1e-5, 1e-6  # f32, one layer, summation order differs
# f32 stacks: max|kernel - plain| <= 1e-4 x max|plain| over the output,
# and every entry |kernel - plain| <= 2e + 1e-6, where e bounds how far
# any f32 evaluation of the stack may lie from the exact one
# (f32_chain_bound). Live RadiX-net columns grow to ~1e34 and early-layer
# cancellation against the bias leaves a few columns ill-conditioned, so a
# fixed per-column rtol cannot hold both f32 orders to one another there;
# the bound holds each entry to what its own column's arithmetic allows.
STACK_RTOL, STACK_ATOL = 1e-4, 1e-6
BF16_ULPS = 4  # bf16 panels, per column: 4 ulp(bf16) x max|plain| + atol
BF16_DEPTH = 8  # layers of the bf16-panel comparison
WIDE = 2048  # columns of the fused kernels' occupancy probe

KERNEL_SOURCES = {
    "bsr_spmm": ("src/repro_torch/csrc/bsr_spmm.cu", "src/repro/kernels/bsr_spmm.py:142"),
    "bcsr_spmm": ("src/repro_torch/csrc/bcsr_spmm.cu", "src/repro/kernels/bcsr_spmm.py:165"),
    "fused_mlp_forward": ("src/repro_torch/csrc/fused_mlp.cu",
                          "src/repro/kernels/fused_mlp.py:214"),
    "fused_mlp_tiled_forward": ("src/repro_torch/csrc/fused_mlp.cu",
                                "src/repro/kernels/fused_mlp.py:409"),
}


def check(ok: bool, detail) -> None:
    """Fail the run (a raised error, so the exit code is not 0)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {detail}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_time_ms(fn, *, per_rep: int, reps: int) -> float:
    """Median device time of one call of ``fn``: each repetition queues
    ``per_rep`` calls behind a sleep kernel (so host overhead is hidden)
    between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nonzero_weights(a) -> int:
    """Nonzero values in the stored (valid) blocks of a BSR, block-CSR or
    stacked BSR matrix: the products a panel column needs."""
    import torch

    blocks, keep = (a.values, a.valid) if hasattr(a, "row_ptr") else (a.blocks, a.block_mask)
    return int(torch.count_nonzero(blocks * keep[..., None, None]))


def spmm_work(a, n: int) -> tuple[float, float]:
    """(bytes, flops) one fused SpMM layer needs on an (k, n) panel."""
    m, k = a.shape
    bs_r, bs_c = a.block_shape
    # the index arrays the launch reads: row_ptr/col_idx/valid or col_idx/mask
    index = (a.row_ptr, a.col_idx, a.valid) if hasattr(a, "row_ptr") else (
        a.col_idx, a.block_mask)
    index_bytes = sum(t.numel() * t.element_size() for t in index)
    valid = a.nnz_blocks()
    nbytes = valid * bs_r * bs_c * 4 + index_bytes + k * n * 4 + m * 4 + m * n * 4
    return nbytes, 2.0 * nonzero_weights(a) * n


def stack_work(stacked_w, n: int) -> tuple[float, float]:
    """(bytes, flops) of a whole fused stack on an (m, n) panel."""
    n_layers, nrb, mbpr = stacked_w.col_idx.shape
    m = stacked_w.shape[0]
    bs = stacked_w.block_shape[0]
    valid = stacked_w.nnz_blocks()
    nbytes = (valid * bs * bs * 4 + n_layers * nrb * mbpr * 5
              + n_layers * m * 4 + 2 * m * n * 4)
    return nbytes, 2.0 * nonzero_weights(stacked_w) * n


def f32_chain_bound(weights, biases, y0):
    """(Y, e): the exact forward pass of a BSR stack on ``y0``, to f64
    rounding, and an elementwise bound ``e`` on |f32 evaluation - Y| for
    any summation order. A layer output sums at most n nonzero products
    and the bias, so its rounding error is at most
    gamma x (|W|·|Y_f32| + |b|), gamma = (n+1)u / (1 - (n+1)u), u = 2^-24
    (the dot-product bound of Higham, Accuracy and Stability of Numerical
    Algorithms, §3.1); |Y_f32| <= |Y| + e, earlier errors carry through
    |W|, and ReLU is 1-Lipschitz."""
    import torch

    from repro_torch.sparse import ops as sparse_ops
    from repro_torch.sparse.bsr import BlockSparseMatrix

    u = 2.0 ** -24
    y = y0.double()
    e = torch.zeros_like(y)
    per_weight = {}  # RadiX-net layers of one phase share one matrix
    for w, b in zip(weights, biases):
        if id(w) not in per_weight:
            nz = (w.blocks != 0) & w.block_mask[..., None, None]
            terms = int(nz.sum(dim=(1, 3)).max()) + 1
            per_weight[id(w)] = (
                BlockSparseMatrix(w.blocks.double(), w.col_idx, w.block_mask, w.shape,
                                  w.block_shape),
                BlockSparseMatrix(w.blocks.double().abs(), w.col_idx, w.block_mask, w.shape,
                                  w.block_shape),
                terms * u / (1 - terms * u),
            )
        w64, abs_w64, gamma = per_weight[id(w)]
        b64 = b.double()[:, None]
        z = sparse_ops.bsr_matmul(w64, y) + b64
        e = (sparse_ops.bsr_matmul(abs_w64, e)
             + gamma * (sparse_ops.bsr_matmul(abs_w64, y.abs() + e) + b64.abs()))
        y = torch.clamp_min(z, 0)
    return y, e


def col_rel(got, want) -> float:
    """Worst column's max |got - want| over that column's max |want|
    (columns where ``want`` is all zero are left out)."""
    col_diff, col_scale = (got - want).abs().amax(dim=0), want.abs().amax(dim=0)
    live = col_scale > 0
    return float((col_diff[live] / col_scale[live]).max()) if bool(live.any()) else 0.0


def errors(got, want) -> dict:
    """Largest absolute error, the worst live column's relative error
    (``col_rel``) and the largest error in a dead (all-zero) column."""
    col_diff, dead = (got - want).abs().amax(dim=0), want.abs().amax(dim=0) == 0
    return {"max_abs_err": float(col_diff.max()),
            "max_col_rel_err": col_rel(got, want),
            "dead_col_abs_err": float(col_diff[dead].max()) if bool(dead.any()) else 0.0}


def columns_within(got, want, rtol: float, atol: float) -> bool:
    """Every column: max_i |got - want| <= rtol * max_i |want| + atol."""
    col_diff = (got - want).abs().amax(dim=0)
    return bool((col_diff <= rtol * want.abs().amax(dim=0) + atol).all())


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU host")
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    logs = build.build()
    report = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln or "smem" in ln]
        for name, log in logs.items()
    }
    info = {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_seconds": time.perf_counter() - t0,
        "ptxas": report,
    }
    emit(info)
    return info


def phase_kernels() -> dict:
    """Each kernel against its plain version at the serving shapes."""
    import torch

    from repro_torch.core.dnn import stack_bsr
    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import DEFAULT_BLOCK_N, ops
    from repro_torch.kernels.bcsr_spmm import bcsr_spmm_plain
    from repro_torch.kernels.bsr_spmm import bsr_spmm_plain
    from repro_torch.kernels.fused_mlp import fused_mlp_plain
    from repro_torch.plan.layout import preferred_layout
    from repro_torch.sparse.bcsr import BlockCSRMatrix

    dev = torch.device("cuda")
    n = 512
    out = {}
    spec = rx.RadixNetSpec(1024, 120)
    weights, biases = rx.radixnet_weights(spec, device=dev)
    ell = weights[1]  # stride-32 phase: 32 stored diagonal blocks per row
    csr = BlockCSRMatrix.from_bsr(weights[0])  # stride-1 phase, as relayouted
    check(preferred_layout(ell) == "ell" and preferred_layout(weights[0]) == "bcsr",
          "RadiX-net 1024 phase layouts")
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.random((1024, n), dtype=np.float32)).to(dev)
    b = biases[0]

    for name, a, kern, plain in (
        ("bsr_spmm", ell, ops.bsr_spmm, bsr_spmm_plain),
        ("bcsr_spmm", csr, ops.bcsr_spmm, bcsr_spmm_plain),
    ):
        got = kern(a, y, b, fuse_bias_relu=True)
        want = plain(a, y, b, fuse_bias_relu=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=SPMM_RTOL, atol=SPMM_ATOL)
        dense = a.to_dense()
        bias_col = b[:, None]
        lib = torch.addmm(bias_col, dense, y)  # yardstick only: no ReLU
        torch.testing.assert_close(torch.clamp_min(lib, 0), want, rtol=SPMM_RTOL,
                                   atol=SPMM_ATOL)
        nbytes, flops = spmm_work(a, n)
        bms, by = bound(nbytes, flops)
        out[name] = {
            **errors(got, want),
            "ms": gpu_time_ms(lambda: kern(a, y, b, fuse_bias_relu=True), per_rep=20, reps=5),
            "plain_ms": gpu_time_ms(lambda: plain(a, y, b, fuse_bias_relu=True),
                                    per_rep=5, reps=5),
            "library_ms": gpu_time_ms(lambda: torch.addmm(bias_col, dense, y),
                                      per_rep=20, reps=5),
            "bound_ms": bms, "bound_by": by, "shape": [1024, 1024, n],
            "stored_blocks": a.nnz_blocks(), "nonzero_weights": nonzero_weights(a),
        }

    # fused, resident: the whole 1024 x 120 stack on the first 512 inputs
    panel = rx.radixnet_input_panel(1024, 60000, density=0.3, seed=0)[:, :WIDE]
    wide_y0 = torch.from_numpy(np.ascontiguousarray(panel)).to(dev)
    y0 = wide_y0[:, :n].contiguous()
    sw, sb = stack_bsr(weights), torch.stack(biases)
    big_spec = rx.RadixNetSpec(16384, 120)
    big_w, big_b = rx.radixnet_weights(big_spec, device=dev)
    bsw, bsb = stack_bsr(big_w), torch.stack(big_b)
    big_wide_y0 = torch.from_numpy(
        rx.radixnet_input_panel(16384, WIDE, density=0.4, seed=0)).to(dev)
    big_y0 = big_wide_y0[:, :n].contiguous()
    for name, kern, args, wide, layer_w, layer_b in (
        ("fused_mlp_forward", ops.fused_mlp_forward, (sw, sb, y0), wide_y0, weights, biases),
        ("fused_mlp_tiled_forward", ops.fused_mlp_tiled_forward, (bsw, bsb, big_y0),
         big_wide_y0, big_w, big_b),
    ):
        got = kern(*args)
        want = fused_mlp_plain(*args)
        torch.cuda.synchronize()
        err = errors(got, want)
        exact, e = f32_chain_bound(layer_w, layer_b, args[2])
        slack = 2 * e + STACK_ATOL
        err["bound_share"] = float(((got.double() - want.double()).abs() / slack).max())
        err["col_rel_err_vs_exact"] = {"kernel": col_rel(got.double(), exact),
                                       "plain": col_rel(want.double(), exact)}
        check(err["max_abs_err"] <= STACK_RTOL * float(want.abs().max()), (name, err))
        check(err["bound_share"] <= 1.0, (name, err))
        cats_got = rx.reference_categories(got.cpu().numpy())
        cats_want = rx.reference_categories(want.cpu().numpy())
        check(np.array_equal(cats_got, cats_want), (name, cats_got, cats_want))
        check(0 < len(cats_want) < n, (name, len(cats_want)))
        # bf16 panels, compared in the working type, at a cut depth
        cut_w = type(args[0])(args[0].blocks[:BF16_DEPTH], args[0].col_idx[:BF16_DEPTH],
                              args[0].block_mask[:BF16_DEPTH], args[0].shape,
                              args[0].block_shape)
        cut = (cut_w, args[1][:BF16_DEPTH], args[2])
        got16 = kern(*cut, panel_dtype="bfloat16")
        want16 = fused_mlp_plain(*cut, panel_dtype="bfloat16")
        err16 = errors(got16, want16)
        rtol16 = BF16_ULPS * 2.0 ** -8
        check(columns_within(got16, want16, rtol16, STACK_ATOL), (name, err16, rtol16))
        nbytes, flops = stack_work(args[0], n)
        bms, by = bound(nbytes, flops)
        reps = 3
        out[name] = {
            **err,
            "categories": int(len(cats_want)),
            "bf16": {**err16, "rtol": rtol16, "layers": BF16_DEPTH},
            "ms": gpu_time_ms(lambda: kern(*args), per_rep=1, reps=reps),
            "plain_ms": gpu_time_ms(lambda: fused_mlp_plain(*args), per_rep=1, reps=reps),
            "library_ms": None,
            "bound_ms": bms, "bound_by": by,
            "shape": [args[0].shape[0], int(args[1].shape[0]), n],
            "stored_blocks": args[0].nnz_blocks(),
            "nonzero_weights": nonzero_weights(args[0]),
            "weight_bytes_per_stripe": args[0].nnz_blocks() * 4 * args[0].block_shape[0] ** 2,
            "ctas": n // DEFAULT_BLOCK_N,
            # occupancy probe: the same stack on a 4x wider panel (4x the CTAs)
            "wide": {"columns": WIDE, "ctas": WIDE // DEFAULT_BLOCK_N,
                     "ms": gpu_time_ms(lambda: kern(args[0], args[1], wide),
                                       per_rep=1, reps=reps)},
        }
    emit({"phase": "kernels", **out})
    return out


def phase_serve(spec, *, n_inputs, use_resident, density, ref_cols, route, level,
                kernels) -> dict:
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.serve import run_challenge

    ops.reset_launch_counts()
    res = run_challenge(spec, n_inputs=n_inputs, use_resident=use_resident,
                        density=density, device="cuda")
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    check(res.routes == (route,), ("routes", res.routes))
    check(res.levels == (level,), ("levels", res.levels))
    check(res.served == n_inputs, ("served", res.served))
    for name in kernels:
        check(counts[name] > 0, (name, counts))
    panel = rx.radixnet_input_panel(spec.neurons, n_inputs, density=density, seed=0)
    ref_y, ref_cats = rx.radixnet_reference(spec, np.ascontiguousarray(panel[:, :ref_cols]))
    check(np.isfinite(ref_y).all(), "finite reference activations")
    check(0 < len(ref_cats) < ref_cols, ("nondegenerate answer set", len(ref_cats)))
    got = res.categories[res.categories < ref_cols]
    check(np.array_equal(got, ref_cats), (got, ref_cats))
    info = {
        "spec": [spec.neurons, spec.layers], "n_inputs": n_inputs, "density": density,
        "routes": list(res.routes), "levels": list(res.levels), "steps": res.steps,
        "width_classes": list(res.width_classes), "launches": counts,
        "seconds": res.seconds, "edge_inputs_per_sec": res.edge_inputs_per_sec,
        "categories": int(len(res.categories)), "reference_columns": ref_cols,
        "reference_categories": int(len(ref_cats)),
    }
    return info


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.data.radixnet import RadixNetSpec

    dev = phase_device()
    kern = phase_kernels()

    serve = phase_serve(RadixNetSpec(1024, 120), n_inputs=60000, use_resident=None,
                        density=0.3, ref_cols=512, route="fused", level="resident",
                        kernels=("fused_mlp_forward",))
    # one launch per step plus the warmup panel, and nothing else
    check(serve["launches"]["fused_mlp_forward"] == serve["steps"] + 1, serve)
    emit({"phase": "serve", **serve})

    layered = phase_serve(RadixNetSpec(1024, 120), n_inputs=2048, use_resident=False,
                          density=0.3, ref_cols=512, route="layered", level="layered",
                          kernels=("bsr_spmm", "bcsr_spmm"))
    emit({"phase": "layered", **layered})

    tiled = phase_serve(RadixNetSpec(16384, 120), n_inputs=1024, use_resident=None,
                        density=0.4, ref_cols=64, route="fused-tiled", level="resident",
                        kernels=("fused_mlp_tiled_forward",))
    emit({"phase": "tiled", **tiled})

    launches = {
        "fused_mlp_forward": serve["launches"]["fused_mlp_forward"],
        "bsr_spmm": layered["launches"]["bsr_spmm"],
        "bcsr_spmm": layered["launches"]["bcsr_spmm"],
        "fused_mlp_tiled_forward": tiled["launches"]["fused_mlp_tiled_forward"],
    }
    emit({"kernels": [
        {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": kern[name]["max_abs_err"],
            "max_col_rel_err": kern[name]["max_col_rel_err"],
            "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"],
            "bound_ms": kern[name]["bound_ms"], "bound_by": kern[name]["bound_by"],
            "library_ms": kern[name]["library_ms"],
        }
        for name, (src, replaces) in KERNEL_SOURCES.items()
    ]})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
