#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GraphChallenge and GraphBLAS paths on one GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA host

Phases (each prints one JSON line; any failure raises, exit code != 0):

1. device    — a CUDA card must be present; print its name and power
   limit, build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, all at once) and print nvcc's register/spill report; the
   register-tiled kernels (all five) must spill nothing.
2. kernels   — each of the five kernels against its plain PyTorch
   version at the serving shapes (RadiX-net 1024 neurons, block 16,
   panel 512; 16384 neurons for the tiled kernel; the dense kernel on a
   densified 1024 × 1024 layer): error, median time from CUDA events,
   the plain version's time, the bound and a library yardstick where one
   PyTorch call computes the same function, the stored work folded per
   second (``tflops``) and the time over the library's (``vs_library``);
   the three semiring kernels also on an 8-column panel (``narrow``);
   ``bcsr_spmm`` also where its work is: RadiX-net's stride-32 layer as
   block-CSR (``stride32``, the same 2048 stored blocks as ``bsr_spmm``'s
   row) and the graphblas phase's skewed 8192 × 8192 adjacency at 256
   and 8 columns (``skewed``, with its piece count and cut rows), each
   beside the ``addmm`` of its dense form; the two fused kernels with
   their launch (``cluster``, ``ctas``, what the card holds at once) and
   a 2048-column ``wide`` probe with its time over the 512-column time. Then ``semirings``: the
   three semiring kernels in all eight semirings on integer-valued
   operands with an empty block-row, ELL pad slots and block-CSR tail
   slots — exact, ``log_plus`` within 1e-5 — with their times.
3. serve     — ``run_challenge(RadixNetSpec(1024, 120))``: all 60 000
   inputs in 512-column panels through ``SparseDNNEngine`` on route
   ``fused``; categories against the numpy reference on 512 inputs.
4. layered   — the same spec with ``use_resident=False`` on 2 048 inputs:
   route ``layered`` through both SpMM kernels.
5. tiled     — ``RadixNetSpec(16384, 120)`` on 1 024 inputs at input
   density 0.4: route ``fused-tiled``.
6. dense     — the paper's BLAS arm: the same 1024 × 120 network with
   every distinct layer matrix densified once, 2 048 inputs through
   ``SparseDNNEngine`` on route ``layered``, every layer ``kernel-dense``
   (``semiring_matmul`` only); categories against the numpy reference
   on all 2 048 inputs. With ``layered`` it is the paper's sparse-vs-
   dense point on this card at inverse sparsity 32.
7. graphblas — the reference's GNN arm (benchmarks/kernel_bench.py
   ``gnn_arm``) at card scale: a power-law 8192 × 8192 adjacency (block
   16, 8192 stored blocks, skew 0.8, seed 5) handed over as ELL; two
   ``plus_times`` graph-convolution rounds through ``gb.mxm`` against
   the ``use_kernel=False`` oracle, ``min_plus`` Bellman-Ford through
   ``gb.mxv`` against numpy bit for bit, one ``lor_land`` BFS step
   through ``gb.vxm``, and the paper's three-call ``dnn_forward(
   fused=False)`` on RadiX-net 1024 × 120 with 2 048 inputs; it prints
   the adjacency's longest and median block-row.

Launch counts are reset to 0 right before each of phases 3-7 and read
right after. The ``kernels`` line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}`` close the run. Numbers are this run's
own; the bound of a kernel is max(bytes / 3.35 TB/s, ops / 67 TFLOP/s)
(H100 SXM HBM3 rate and f32 CUDA-core peak at 700 W), counting the
stored blocks' values, the index arrays, bias, the panel read once and
the output written once, and 2·n operations (one ⊗, one ⊕) per weight
the product needs: the nonzero weights under ``plus_times`` (zeros
inside stored blocks are not work these inputs need), every stored entry
under the other semirings, whose zero is not 0.
"""

from __future__ import annotations

import json
import os
import re
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
LOG_PLUS_TOL = 1e-5  # the reference's TOL: its reductions chain in another order
GNN_TOL = 1e-5  # gnn_arm's scale-normalised conv agreement

NARROW_N = 8  # the narrow-panel timing of the redesigned kernels (an mxv's width)
# the graphblas phase's adjacency: random_skewed(SKEWED_SEED, (m, m), (16, 16), blocks, skew)
SKEWED_M, SKEWED_BLOCKS, SKEWED_SKEW, SKEWED_SEED = 8192, 8192, 0.8, 5
KERNEL_SOURCES = {
    "semiring_matmul": ("src/repro_torch/csrc/semiring_matmul.cu",
                        "src/repro/kernels/semiring_matmul.py:112"),
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


def spmm_work(a, n: int, semiring: str = "plus_times") -> tuple[float, float]:
    """(bytes, ops) one fused SpMM layer needs on an (k, n) panel."""
    m, k = a.shape
    bs_r, bs_c = a.block_shape
    # the index arrays the launch reads: row_ptr/col_idx/valid or col_idx/mask
    index = (a.row_ptr, a.col_idx, a.valid) if hasattr(a, "row_ptr") else (
        a.col_idx, a.block_mask)
    index_bytes = sum(t.numel() * t.element_size() for t in index)
    valid = a.nnz_blocks()
    nbytes = valid * bs_r * bs_c * 4 + index_bytes + k * n * 4 + m * 4 + m * n * 4
    weights = nonzero_weights(a) if semiring == "plus_times" else valid * bs_r * bs_c
    return nbytes, 2.0 * weights * n


def stored_work(a, n: int) -> float:
    """Operations a kernel folds for an (·, n) panel: 2 per stored
    weight (zeros inside stored blocks included) and column."""
    bs_r, bs_c = a.block_shape
    return 2.0 * a.nnz_blocks() * bs_r * bs_c * n


def rates(ms: float, work: float, library_ms) -> dict:
    """The work folded per second, and the time against the library's."""
    return {"tflops": work / ms / 1e9,
            "vs_library": None if library_ms is None else ms / library_ms}


def dense_work(m: int, k: int, n: int) -> tuple[float, float]:
    """(bytes, ops) of one dense (m, k) × (k, n) product with its bias."""
    return 4.0 * (m * k + k * n + m + m * n), 2.0 * m * k * n


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
    # every kernel is register-tiled over cp.async stages: none may spill
    for source in sorted({os.path.basename(src)[:-3] for src, _ in KERNEL_SOURCES.values()}):
        spills = [int(v) for ln in report[source] for v in re.findall(r"(\d+) bytes spill", ln)]
        check(spills and not any(spills), (source, "spills registers", spills))
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
    from repro_torch.kernels import ops
    from repro_torch.kernels.bcsr_spmm import bcsr_spmm_plain, piece_table
    from repro_torch.kernels.bsr_spmm import bsr_spmm_plain
    from repro_torch.kernels.fused_mlp import card_geometry, fused_mlp_plain
    from repro_torch.kernels.semiring_matmul import semiring_matmul_plain
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
    y_narrow = y[:, :NARROW_N].contiguous()
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
        ms = gpu_time_ms(lambda: kern(a, y, b, fuse_bias_relu=True), per_rep=20, reps=5)
        library_ms = gpu_time_ms(lambda: torch.addmm(bias_col, dense, y), per_rep=20, reps=5)
        out[name] = {
            **errors(got, want),
            "ms": ms,
            "plain_ms": gpu_time_ms(lambda: plain(a, y, b, fuse_bias_relu=True),
                                    per_rep=5, reps=5),
            "library_ms": library_ms, **rates(ms, stored_work(a, n), library_ms),
            "bound_ms": bms, "bound_by": by, "shape": [1024, 1024, n],
            "stored_blocks": a.nnz_blocks(), "nonzero_weights": nonzero_weights(a),
        }
        out[name]["narrow"] = panel_timing(kern, plain, a, dense, y_narrow, b,
                                           stored_work(a, NARROW_N), spmm_work(a, NARROW_N))

    # bcsr_spmm where its work is: the stride-32 layer as block-CSR, and the
    # graphblas phase's skewed adjacency (long block-rows cut into pieces)
    stride32 = BlockCSRMatrix.from_bsr(ell)
    out["bcsr_spmm"]["stride32"] = {
        "stored_blocks": stride32.nnz_blocks(), "pieces": piece_table(stride32).n_pieces,
        "n512": panel_timing(ops.bcsr_spmm, bcsr_spmm_plain, stride32, ell.to_dense(), y, b,
                             stored_work(stride32, n), spmm_work(stride32, n))}
    skewed = BlockCSRMatrix.random_skewed(SKEWED_SEED, (SKEWED_M, SKEWED_M), (16, 16),
                                          SKEWED_BLOCKS, skew=SKEWED_SKEW, device=dev)
    table = piece_table(skewed)
    g = torch.Generator(device=dev).manual_seed(SKEWED_SEED)
    skew_y = torch.rand((SKEWED_M, 256), generator=g, device=dev)
    skew_b = torch.randn((SKEWED_M,), generator=g, device=dev)
    skew_dense = skewed.to_dense()
    out["bcsr_spmm"]["skewed"] = {
        "shape": [SKEWED_M, SKEWED_M], "stored_blocks": skewed.nnz_blocks(),
        "pieces": table.n_pieces, "cut_rows": table.n_cut_rows,
        "cut_pieces": table.n_cut_pieces,
        **{f"n{w}": panel_timing(ops.bcsr_spmm, bcsr_spmm_plain, skewed, skew_dense,
                                 skew_y[:, :w].contiguous(), skew_b, stored_work(skewed, w),
                                 spmm_work(skewed, w))
           for w in (256, NARROW_N)}}
    del skew_dense

    # dense: a densified stride-32 layer, as the dense phase runs it
    w_dense = ell.to_dense()
    got = ops.semiring_matmul(w_dense, y, b, fuse_bias_relu=True)
    want = semiring_matmul_plain(w_dense, y, b, fuse_bias_relu=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=SPMM_RTOL, atol=SPMM_ATOL)
    bias_col = b[:, None]
    bms, by = bound(*dense_work(1024, 1024, n))
    ms = gpu_time_ms(lambda: ops.semiring_matmul(w_dense, y, b, fuse_bias_relu=True),
                     per_rep=10, reps=5)
    library_ms = gpu_time_ms(lambda: torch.addmm(bias_col, w_dense, y), per_rep=10, reps=5)
    out["semiring_matmul"] = {
        **errors(got, want),
        "ms": ms,
        "plain_ms": gpu_time_ms(lambda: semiring_matmul_plain(w_dense, y, b, fuse_bias_relu=True),
                                per_rep=10, reps=5),
        "library_ms": library_ms, **rates(ms, dense_work(1024, 1024, n)[1], library_ms),
        "bound_ms": bms, "bound_by": by, "shape": [1024, 1024, n],
        "narrow": panel_timing(ops.semiring_matmul, semiring_matmul_plain, w_dense, w_dense,
                               y_narrow, b, dense_work(1024, 1024, NARROW_N)[1],
                               dense_work(1024, 1024, NARROW_N)),
    }
    out["semirings"] = semiring_checks(weights[1], dev, n)

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
        ms = gpu_time_ms(lambda: kern(*args), per_rep=1, reps=reps)
        tiled = name == "fused_mlp_tiled_forward"
        geo, at_once = card_geometry(args[0], n, tiled=tiled, device=dev)
        wide_geo, _ = card_geometry(args[0], WIDE, tiled=tiled, device=dev)
        wide_ms = gpu_time_ms(lambda: kern(args[0], args[1], wide), per_rep=1, reps=reps)
        out[name] = {
            **err,
            "categories": int(len(cats_want)),
            "bf16": {**err16, "rtol": rtol16, "layers": BF16_DEPTH},
            "ms": ms,
            "plain_ms": gpu_time_ms(lambda: fused_mlp_plain(*args), per_rep=1, reps=reps),
            "library_ms": None, **rates(ms, stored_work(args[0], n), None),
            "bound_ms": bms, "bound_by": by,
            "shape": [args[0].shape[0], int(args[1].shape[0]), n],
            "stored_blocks": args[0].nnz_blocks(),
            "nonzero_weights": nonzero_weights(args[0]),
            "weight_bytes_per_stripe": args[0].nnz_blocks() * 4 * args[0].block_shape[0] ** 2,
            "cluster": geo.cluster, "ctas": geo.ctas, "smem_bytes": geo.smem_bytes,
            # resident: clusters of this size the card holds at once; tiled: CTAs an SM holds
            ("clusters_at_once" if not tiled else "ctas_per_sm"): at_once,
            # occupancy probe: the same stack on a 4x wider panel (4x the work); a
            # ratio near 4 says the 512-column launch already fills the card
            "wide": {"columns": WIDE, "cluster": wide_geo.cluster, "ctas": wide_geo.ctas,
                     "ms": wide_ms, "ratio_to_512": wide_ms / ms},
        }
    emit({"phase": "kernels", **out})
    return out


def panel_timing(kern, plain, a, dense, y, b, work: float, bytes_ops) -> dict:
    """A kernel on one more panel (an 8-column one runs the narrow tile):
    checked against the plain version, timed beside it and beside one
    ``torch.addmm`` of the same product on ``dense``, ``a``'s dense form."""
    import torch

    got = kern(a, y, b, fuse_bias_relu=True)
    want = plain(a, y, b, fuse_bias_relu=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=SPMM_RTOL, atol=SPMM_ATOL)
    bias_col = b[:, None]
    ms = gpu_time_ms(lambda: kern(a, y, b, fuse_bias_relu=True), per_rep=20, reps=5)
    library_ms = gpu_time_ms(lambda: torch.addmm(bias_col, dense, y), per_rep=20, reps=5)
    bms, by = bound(*bytes_ops)
    return {**errors(got, want), "n": int(y.shape[1]), "ms": ms,
            "plain_ms": gpu_time_ms(lambda: plain(a, y, b, fuse_bias_relu=True),
                                    per_rep=5, reps=5),
            "library_ms": library_ms, **rates(ms, work, library_ms),
            "bound_ms": bms, "bound_by": by}


def semiring_checks(topology, dev, n: int) -> dict:
    """The three semiring kernels in all eight semirings against their
    plain versions, on integer-valued operands: a RadiX-net topology
    (the stride-32 phase at 1024 × 1024, block 16) with block-row 1
    emptied and the last four slots of block-row 2 turned into ELL pad
    slots, its block-CSR form with two tail slots, a dense matrix of the
    same shape, and a (k, n) panel, all with values in [-3, 3]. Exact (integer sums
    stay far below 2^24), ``log_plus`` within LOG_PLUS_TOL."""
    import torch

    from repro_torch.core.semiring import REGISTRY
    from repro_torch.kernels import ops
    from repro_torch.kernels.bcsr_spmm import bcsr_spmm_plain
    from repro_torch.kernels.bsr_spmm import bsr_spmm_plain
    from repro_torch.kernels.semiring_matmul import semiring_matmul_plain
    from repro_torch.kernels.semirings import kernel_zero
    from repro_torch.sparse.bcsr import BlockCSRMatrix
    from repro_torch.sparse.bsr import BlockSparseMatrix

    g = torch.Generator(device=dev).manual_seed(3)

    def ints(*shape):
        return torch.randint(-3, 4, shape, generator=g, device=dev).float()

    mask = topology.block_mask.clone()
    mask[1] = False
    mask[2, -4:] = False
    blocks = torch.where(mask[:, :, None, None], ints(*topology.blocks.shape), 0.0)
    col_idx = torch.where(mask, topology.col_idx, 0)
    ell = BlockSparseMatrix(blocks, col_idx, mask, topology.shape, topology.block_shape)
    csr = BlockCSRMatrix.from_bsr(ell, pad_to=ell.nnz_blocks() + 2)
    m, k = topology.shape
    dense, y = ints(m, k), ints(k, n)
    check(not bool(ell.block_mask.all()) and int(csr.valid.sum()) == csr.total_blocks - 2,
          "semiring operands carry pad slots and tail slots")
    results = {}
    for kname, kern, plain, a in (
        ("semiring_matmul", ops.semiring_matmul, semiring_matmul_plain, dense),
        ("bsr_spmm", ops.bsr_spmm, bsr_spmm_plain, ell),
        ("bcsr_spmm", ops.bcsr_spmm, bcsr_spmm_plain, csr),
    ):
        per = {}
        for name in sorted(REGISTRY):
            got = kern(a, y, semiring_name=name)
            want = plain(a, y, semiring_name=name)
            torch.cuda.synchronize()
            diff = (got - want).abs().nan_to_num(nan=float("inf"))
            finite = torch.isfinite(want)
            err = float(diff[finite].max()) if bool(finite.any()) else 0.0
            same_inf = bool(torch.equal(got[~finite], want[~finite]))
            if name == "log_plus":
                ok = same_inf and bool((diff[finite] <= LOG_PLUS_TOL * (1 + want[finite].abs())).all())
                rule = f"within {LOG_PLUS_TOL} (rtol and atol)"
            else:
                ok = bool(torch.equal(got, want))
                rule = "bit-exact"
            check(ok, (kname, name, err))
            if a is not dense:
                check(bool((got[16:32] == kernel_zero(name)).all()), (kname, name, "empty row"))
            nbytes, ops_ = dense_work(m, k, n) if a is dense else spmm_work(a, n, name)
            bms, by = bound(nbytes, ops_)
            library = None
            if name == "plus_times":
                lib_a = a if a is dense else a.to_dense()
                library = gpu_time_ms(lambda: torch.matmul(lib_a, y), per_rep=5, reps=3)
            ms = gpu_time_ms(lambda: kern(a, y, semiring_name=name), per_rep=5, reps=3)
            work = dense_work(m, k, n)[1] if a is dense else stored_work(a, n)
            per[name] = {
                "max_abs_err": err, "check": rule, "ms": ms,
                "plain_ms": gpu_time_ms(lambda: plain(a, y, semiring_name=name),
                                        per_rep=2, reps=3),
                "bound_ms": bms, "bound_by": by, "library_ms": library,
                **rates(ms, work, library),
            }
        results[kname] = per
    return results


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


def radix_inputs(spec, n_inputs: int, density: float):
    """The challenge input panel (Philox, seed 0) and the numpy oracle's
    categories on all of it."""
    from repro_torch.data import radixnet as rx

    panel = np.ascontiguousarray(
        rx.radixnet_input_panel(spec.neurons, n_inputs, density=density, seed=0))
    ref_y, ref_cats = rx.radixnet_reference(spec, panel)
    check(np.isfinite(ref_y).all(), "finite reference activations")
    check(0 < len(ref_cats) < n_inputs, ("nondegenerate answer set", len(ref_cats)))
    return panel, ref_cats


def phase_dense(spec, panel, ref_cats, *, panel_width: int = 512) -> dict:
    """The BLAS arm: the RadiX-net stack with each distinct layer matrix
    densified once, served panel by panel through the engine."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.serve import SparseDNNEngine

    dev = torch.device("cuda")
    weights, biases = rx.radixnet_weights(spec, device=dev)
    dense = {id(w): w.to_dense() for w in weights}  # phases stay shared
    engine = SparseDNNEngine([dense[id(w)] for w in weights], biases, batch_align=32,
                             device=dev)
    y0 = torch.from_numpy(panel).to(dev)
    n_inputs = y0.shape[1]
    ops.reset_launch_counts()
    engine.submit(y0[:, :panel_width])  # warmup panel, untimed
    engine.step(pad_to=panel_width)
    torch.cuda.synchronize()
    active = torch.zeros((n_inputs,), dtype=torch.bool, device=dev)
    stats = []
    t0 = time.perf_counter()
    for start in range(0, n_inputs, panel_width):
        chunk = y0[:, start:start + panel_width]
        engine.submit(chunk)
        out, st = engine.step(pad_to=panel_width)
        active[start:start + chunk.shape[1]] = (out > 0).any(dim=0)
        stats.append(st)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    routes = sorted({st["plan"]["route"] for st in stats})
    check(routes == ["layered"], ("routes", routes))
    check(counts["semiring_matmul"] == spec.layers * (len(stats) + 1), counts)
    check(all(v == 0 for k, v in counts.items() if k != "semiring_matmul"), counts)
    cats = np.flatnonzero(active.cpu().numpy())
    check(np.array_equal(cats, ref_cats), ("dense categories", len(cats), len(ref_cats)))
    return {
        "spec": [spec.neurons, spec.layers], "n_inputs": n_inputs, "routes": routes,
        "layer_paths": ["kernel-dense"], "steps": len(stats), "launches": counts,
        "seconds": seconds, "inputs_per_sec": n_inputs / seconds,
        "edge_inputs_per_sec": spec.edges * n_inputs / seconds,
        "grid_steps_per_panel": stats[0]["grid_steps"],
        "categories": int(len(cats)), "reference_categories": int(len(ref_cats)),
    }


def bf_relax_numpy(lengths, row_id, col_idx, d):
    """One min_plus relaxation d ← min(d, A ⊕.⊗ d) in numpy over the
    stored blocks (every entry of a stored block is an edge; a missing
    block is +∞): lengths (T, bs, bs), d (m,) float32."""
    bs = lengths.shape[1]
    cand = (lengths + d.reshape(-1, bs)[col_idx][:, None, :]).min(axis=2)  # (T, bs)
    out = d.reshape(-1, bs).copy()
    np.minimum.at(out, row_id, cand)
    return out.reshape(-1)


def phase_graphblas(spec, panel, ref_cats, *, m=SKEWED_M, block=16, total_blocks=SKEWED_BLOCKS,
                    skew=SKEWED_SKEW, seed=SKEWED_SEED, feat=256, rounds=2, bf_cap=64) -> dict:
    """gnn_arm at card scale, one BFS step, and the three-call DNN."""
    import torch

    from repro_torch.core import dnn
    from repro_torch.core import graphblas as gb
    from repro_torch.core.semiring import LOR_LAND, MIN_PLUS
    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.plan.cost import mxv_grid_steps
    from repro_torch.plan.mxm import mxm_cache_stats, mxm_plan, reset_mxm_cache
    from repro_torch.sparse.bcsr import BlockCSRMatrix

    dev = torch.device("cuda")
    t_build = time.perf_counter()
    csr = BlockCSRMatrix.random_skewed(seed, (m, m), (block, block), total_blocks, skew=skew,
                                       device=dev)
    adj = csr.to_bsr()  # the graph's native, badly padded ELL layout
    t_build = time.perf_counter() - t_build
    ops.reset_launch_counts()
    reset_mxm_cache()
    t0 = time.perf_counter()
    plan = mxm_plan(adj, feat)
    check(plan.layout == "bcsr" and plan.grid_steps < plan.xla_equiv_grid_steps,
          (plan.layout, plan.grid_steps, plan.xla_equiv_grid_steps))

    # graph convolution: rounds of relu(A ⊕.⊗ (H·W)), plus_times
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.rand((m, feat), generator=g, device=dev)
    ws = torch.rand((rounds, feat, feat), generator=g, device=dev) - 0.5
    h_kernel, h_oracle = h, h
    for r in range(rounds):
        h_kernel = torch.clamp_min(gb.mxm(adj, h_kernel @ ws[r]), 0.0)
        h_oracle = torch.clamp_min(gb.mxm(adj, h_oracle @ ws[r], use_kernel=False), 0.0)
    torch.cuda.synchronize()
    scale = max(float(h_oracle.abs().max()), 1.0)
    conv_err = float((h_kernel - h_oracle).abs().max()) / scale
    check(conv_err <= GNN_TOL, ("conv", conv_err))
    conv_stats = mxm_cache_stats()
    check(conv_stats["hits"] >= 1, ("conv plan hits", conv_stats))

    # Bellman-Ford: min_plus mxv to a fixpoint, integer lengths in [0, 6]
    lengths = torch.round(csr.values.abs() * 2.0)
    adj_len = BlockCSRMatrix(lengths, csr.row_ptr, csr.row_id, csr.col_idx, csr.valid,
                             csr.shape, csr.block_shape).to_bsr()
    len_np, rows_np, cols_np = (x.cpu().numpy() for x in (lengths, csr.row_id, csr.col_idx))
    d = torch.full((m,), float("inf"), device=dev)
    d[0] = 0.0
    d_np = d.cpu().numpy()
    bf_iters, converged = 0, False
    for _ in range(bf_cap):
        d_next = torch.minimum(d, gb.mxv(adj_len, d, MIN_PLUS))
        d_np = bf_relax_numpy(len_np, rows_np, cols_np, d_np)
        bf_iters += 1
        check(np.array_equal(d_next.cpu().numpy(), d_np), ("bellman-ford", bf_iters))
        if bool(torch.equal(d_next, d)):
            converged = True
            break
        d = d_next
    check(converged, ("bellman-ford converged", bf_iters))
    bf_stats = mxm_cache_stats()
    check(bf_stats["hits"] - conv_stats["hits"] >= 1, ("bf plan hits", bf_stats))

    # one BFS step from the block-row with the fewest (but some) stored blocks
    counts_np = np.diff(csr.row_ptr.cpu().numpy())  # stored blocks a block-row
    src = int(np.flatnonzero(counts_np == counts_np[counts_np > 0].min())[0])
    frontier = torch.zeros((m,), device=dev)
    frontier[src * block:(src + 1) * block] = 1.0
    reached = gb.vxm(frontier, adj, LOR_LAND)
    want = np.zeros((m // block, block), bool)  # column j reached iff some A[i, j] != 0
    vals_np = csr.values.cpu().numpy()
    for t in np.flatnonzero(rows_np == src):
        want[cols_np[t]] |= (vals_np[t] != 0).any(axis=0)
    check(np.array_equal(reached.cpu().numpy() != 0, want.reshape(-1)), "bfs step")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(counts["bcsr_spmm"] > 0, counts)

    # the paper's three-call DNN (Fig. 4) on RadiX-net, 2 048 inputs
    weights, biases = rx.radixnet_weights(spec, device=dev)
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    out = dnn.dnn_forward(weights, biases, torch.from_numpy(panel).to(dev), fused=False)
    torch.cuda.synchronize()
    dnn_seconds = time.perf_counter() - t1
    dnn_counts = ops.launch_counts()
    # 60 stride-1 layers run block-CSR after the relayout, 60 stride-32 ELL
    check(dnn_counts["bsr_spmm"] == dnn_counts["bcsr_spmm"] == spec.layers // 2, dnn_counts)
    cats = rx.reference_categories(out.cpu().numpy())
    check(np.array_equal(cats, ref_cats), ("three-call categories", len(cats), len(ref_cats)))
    return {
        "m": m, "block": block, "total_blocks": total_blocks, "skew": skew, "seed": seed,
        "feat_dim": feat, "rounds": rounds, "bf_iters_cap": bf_cap,
        "build_seconds": t_build,
        "block_row_blocks": {"longest": int(counts_np.max()),
                             "median": float(np.median(counts_np))},
        "source_layout": plan.source_layout, "exec_layout": plan.layout,
        "kernel_grid_steps": plan.grid_steps, "xla_equiv_grid_steps": plan.xla_equiv_grid_steps,
        "mxv_grid_steps": mxv_grid_steps(plan.weight),
        "conv_max_rel_err": conv_err, "conv_plan_builds": conv_stats["builds"],
        "conv_plan_hits": conv_stats["hits"], "bf_iters": bf_iters, "bf_converged": converged,
        "bf_reachable": int(np.isfinite(d_np).sum()), "bf_matches_numpy": True,
        "bf_plan_hits": bf_stats["hits"] - conv_stats["hits"],
        "bfs_source_block_row": src, "bfs_reached": int((reached != 0).sum()),
        "launches": counts, "seconds": seconds,
        "three_call": {"spec": [spec.neurons, spec.layers], "n_inputs": panel.shape[1],
                       "launches": dnn_counts, "seconds": dnn_seconds,
                       "categories": int(len(cats)), "matches_reference": True},
    }


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

    spec = RadixNetSpec(1024, 120)
    panel, ref_cats = radix_inputs(spec, 2048, 0.3)
    dense = phase_dense(spec, panel, ref_cats)
    emit({"phase": "dense", **dense})
    graph = phase_graphblas(spec, panel, ref_cats)
    emit({"phase": "graphblas", **graph})

    by_phase = {"serve": serve["launches"], "layered": layered["launches"],
                "tiled": tiled["launches"], "dense": dense["launches"],
                "graphblas": graph["launches"],
                "three_call": graph["three_call"]["launches"]}
    checks = {name: "max|kernel - plain| <= 1e-5 |plain| + 1e-6 (f32 order)"
              for name in ("semiring_matmul", "bsr_spmm", "bcsr_spmm")}
    checks.update({name: "stack: <= 1e-4 max|plain|, each entry within 2x the f32 bound, "
                         "exact categories"
                   for name in ("fused_mlp_forward", "fused_mlp_tiled_forward")})
    rows = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        row = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(c[name] for c in by_phase.values()),
            "launches_by_phase": {p: c[name] for p, c in by_phase.items() if c[name]},
            "max_abs_err": kern[name]["max_abs_err"],
            "max_col_rel_err": kern[name]["max_col_rel_err"], "check": checks[name],
            "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"],
            "bound_ms": kern[name]["bound_ms"], "bound_by": kern[name]["bound_by"],
            "library_ms": kern[name]["library_ms"],
        }
        if name in kern["semirings"]:
            row["semirings"] = kern["semirings"][name]
        rows.append(row)
    emit({"kernels": rows})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
