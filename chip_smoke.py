#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GraphChallenge, GraphBLAS, training, tuning,
sharded and fleet paths on one GPU.

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
   and 8 columns (``skewed``, with its piece count and cut rows); both
   SpMMs on the paper's 128 × 128 blocks (``block128``: an 8192 × 8192
   layer, 8 of 64 blocks a row, 64 columns), which the wrappers launch
   re-tiled, with the sub-block they launched; each beside the ``addmm``
   of its dense form; the two fused kernels with
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
8. train-radixnet — the training path at full width: RadiX-net 1024 ×
   120's stored blocks (the stride-1 phase as block-CSR) with seeded
   He-scale values, a 512-column Philox panel, a differentiable
   ``StackPlan``, the first step's gradients against the plain versions
   on the card (``GRAD_RTOL``), then 3 SGD steps of
   ``make_sparse_train_step``: the loss must fall, the gradients stay in
   the stored pattern, no transpose is sorted after the plan's build,
   and the launches per step split into forward (one per sparse layer)
   and backward (``bcsr_spmm`` on the cached transpose of every sparse
   layer whose input needs a gradient); forward, backward and
   step times on the synchronised host clock.
9. train-paper — the paper's MLP at a Fig. 5 grid point
   (``graphblas_mlp.make_config(m=8192, num_layers=8,
   inverse_sparsity=8, block=128)``, batch 64): seeded dense weights
   ``block_prune``'d to 8 of 64 blocks a row, every other layer as
   block-CSR; a no-grad forward through a layered plan against the plain
   version (the 128 × 128 blocks reach the kernels as 64 × 64
   sub-blocks, the wrappers' re-tiling), then 2 AdamW steps checked as in
   phase 8, with the block shapes each wrapper launched.
10. continuous — RadiX-net 1024 × 120 through a ``ContinuousBatcher``
   (resident engine, ``batch_size`` 512, width classes 64/128/256/512,
   ``min_fill`` 0, ``max_wait`` 4) serving a ``poissonish_trace`` of
   6 000 single-column requests at a mean of 256 a tick (``CONTINUOUS``),
   each a column of the Philox input panel (density 0.3, seed 0): every
   completed request's category against the numpy oracle on its column,
   one capture per width class used, goodput 1.0, a plan-cache miss for
   each class used and a hit for every other dispatch (the rate is
   printed: a few dozen dispatches hold it far under 0.99), launches =
   replays + warm-ups; the ``ServeStats`` summary, the loop's host
   seconds and edge·inputs/s.
11. continuous-faults — the same batcher on the same trace with a
   seeded injector (NaN panel, transient step, plan-compile failure)
   and a ``VirtualClock``: the poisoned requests
   quarantined, the others' categories exact, the transient step
   retried, the ladder demoted to ``layered`` and restored; the ladder's
   events.
12. serve-bf16 — ``run_challenge`` at 1024 × 120 with
   ``panel_dtype="bfloat16"``: a 512-column panel's output against
   ``fused_mlp_plain(..., panel_dtype="bfloat16")`` within
   ``STACK_RTOL``, the categories that agree with the f32 oracle
   (printed, not held), the bf16 launch's time beside the f32 one's.
13. tune — the autotuner (``repro_torch.tune``): the reference tune
   arm's skewed stack (``TUNE_SKEWED``: three rectangular layers, skew
   0.3, width 64), where ``layout=bcsr`` must win with fewer tile
   products and less block work than the default and give the default
   plan's output within 1e-6 of it; then RadiX-net 1024 × 120 and
   4096 × 120 (``TUNE_RADIX``; input density 0.3 and 0.35) at 512
   columns of the challenge's {0, 1} panel over block_n (default, 8) × panel dtype × layout × shared-memory
   budget (default, and one byte under the f32 resident panel or the
   card's limit): every candidate's route, bill, shared-memory bytes,
   time, error and selection, and whether the selection is the fastest
   measured (evidence only: the cost model selects). No candidate may
   fail to build. The winners go into one ``TuningTable``, saved and
   loaded back.
14. serve-tuned — ``run_challenge(spec, tuning_table=table)`` on all
   60 000 inputs at both sizes and their densities: route, launches (warm-up + replays),
   edge·inputs/s; categories against the numpy oracle on 512 columns
   (held for f32 panels; for bf16 panels a panel is held bit for bit to
   ``fused_mlp_plain`` and the disagreements printed); then an engine
   built with the same table, its plan's tuned token and captured
   launches checked as in the serving phases.
15. train-resilient — ``run_resilient_training`` on train-radixnet's
   network (``RESILIENT``: 12 SGD steps, checkpoints every 4, a batch per
   step): a clean run, a run with a NaN loss at step 6 (one restart,
   step 6 skipped) and a run stopped at step 8 and resumed; both must
   give the clean run's losses bit for bit. The checkpoint's bytes and
   its save, restore and (on the card) validation times.

16. sharded — ``run_challenge(RadixNetSpec(65536, 120), mesh=
   make_row_blocks_mesh(4))`` on the one card (``SHARDED``: 8 192 inputs
   in 512-column panels, input density 0.45): route and level
   ``sharded``, 4 ``bcsr_spmm`` launches a layer a replay (the captured
   graph's kernel nodes), imbalance <= 1.10, the per-shard bills summing
   to the unsharded block-CSR bill, a replay bit-identical to the eager
   forward; at the first layer of each of the 4 distinct partitions,
   every shard's launch (no epilogue, the served panel's 512 columns)
   against ``bcsr_spmm_plain`` on its sub-segment and the summed layer
   against the plain unsharded layer (``SPMM_RTOL``); categories equal to
   the unsharded engine's (its own route) on every input and to the numpy
   oracle on 64, whose final values the served ones match by the stack
   criterion (``STACK_RTOL`` and the f32 bound); edge·inputs/s beside the
   unsharded run's; the heaviest layer's 4 launches against its
   partial-panel sum (CUDA events); then a fresh engine with a shard lost
   at dispatch 1: the timed panels serve from ``layered`` with the same
   categories, one ladder event.
17. sharded-train — train-radixnet's network with every layer block-CSR
   through a differentiable 4-shard plan (``SHARDED_TRAIN``): the first
   step's gradients against the plain versions on the sharded kernels'
   ReLU masks (``GRAD_RTOL``), two backward passes bit-identical, 3 SGD
   steps whose losses are within 1e-5 of the unsharded differentiable
   plan's, launches per step (4 a layer forward, 4 a layer but the first
   backward), step times.
18. fleet — the reference's fleet arm (``FLEET``): 3 replicas of
   RadiX-net 1024 × 120, each its own plan cache, behind
   ``FleetFrontend`` on a ``VirtualClock``; a bursty trace at rate factor
   4 (8 s, seed 17, widths 4 and 24, classes 8 and 24, deadline 0.05 s,
   2 048 pending columns); the service model's price of a billed block
   product is a replayed 24-column plan's time over its bill. Plan hit
   rate >= 0.9, no failed job, launches = the replicas' warm-ups +
   replays; the same trace with replica 0 lost at dispatch 100 drops no
   admitted job; every served job's categories in both runs against the
   numpy oracle.

Every engine plan on the card captures its forward as a CUDA graph at
its first panel (an eager warm-up, then the capture) and replays it for
the others: each serving phase checks that its launches are the
warm-ups' and the replays' (``plan_launches``), and for one plan of each
route reads the kernel nodes of its captured graph through libcuda
and holds them against what the capture recorded and what one more
replay added to the wrappers' counts (``measured_replay``). The layered, dense and
three-call phases also time the captured ``plan.forward`` against the
same layer loop called eagerly through ``kernel_ops`` from this script,
interleaved, five times each, beside the kernels' CUDA-event time
(``host_share``).

Launch counts are reset to 0 right before each of phases 3-18 and read
right after (for 8, 9 and 17, around the train steps; for 18, around
each run of the trace). The ``kernels`` line, the ``nvidia-smi`` line and, last,
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

import dataclasses
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
# the training phases: the first step's gradients, kernels against the plain
# versions on the card with each layer's ReLU mask taken from the kernels'
# forward, per layer tensor ||kernel - plain|| <= GRAD_RTOL ||plain|| (f32
# products summed in another order through the forward and back). With its
# own masks the plain forward puts a few of RadiX-net's 6e7 pre-activations
# within rounding of 0 on the other side (a gradient of a ReLU stack jumps
# there): those flips are counted and their gradient error printed, not held
# to the bound.
GRAD_RTOL = 1e-4
TRAIN_SEED = 7
RADIX_TRAIN = dict(neurons=1024, layers=120, columns=512, steps=3, lr=0.02)
PAPER_TRAIN = dict(m=8192, layers=8, inverse_sparsity=8, block=128, batch=64, steps=2, lr=1e-3)
# the continuous phases: arrivals of poissonish_trace(n_requests, m=1024, lam=lam,
# seed=seed) with the generator's own burst parameters, each request a column of
# the Philox panel. A mean of 256 arrivals a tick fills half of a 512-column
# panel, so about half the ticks' arrivals take the 512 class.
CONTINUOUS = dict(n_requests=6000, lam=256.0, seed=0)
# the tune phase: the reference tune arm's skewed stack
# (benchmarks/kernel_bench.py tune_arm) and RadiX-net at two challenge sizes
TUNE_SKEWED = dict(specs=(((128, 256), 100), ((128, 128), 55), ((64, 128), 28)), skew=0.3,
                   block=16, width=64, reps=3)
# (neurons, input density): at 4096 × 120 every input of a 0.3-density
# panel dies before the last layer (no category on 512 columns, in the
# oracle as in the port), so that size takes 0.35, which keeps about half
TUNE_RADIX = dict(sizes=((1024, 0.3), (4096, 0.35)), layers=120, block=16, width=512, reps=3)
RESILIENT = dict(neurons=1024, layers=120, columns=512, lr=0.02, steps=12, ckpt_interval=4,
                 nan_step=6, kill_step=8)
# the sharded phases: RadiX-net 65536 × 120 (the largest official size) served
# over a mesh of 4 shards on the one card, 8 192 inputs in 512-column panels
# (16 timed panels a route).
# At 0.3–0.4 input density no input of 16 survives to the last layer in the
# oracle; 0.45 keeps 8 of 16, so the cell takes 0.45. The oracle runs on 64
# columns (~120 × 65536 × 32 gathers a column), 8 processes of 8.
SHARDED = dict(neurons=65536, layers=120, shards=4, n_inputs=8192, density=0.45, ref_cols=64)
SHARDED_TRAIN = dict(neurons=1024, layers=120, columns=512, steps=3, lr=0.02, shards=4)
# the fleet phase: the reference's fleet arm (benchmarks/kernel_bench.py fleet_arm,
# its full config) at rate factor 4, over RadiX-net 1024 × 120
FLEET = dict(neurons=1024, layers=120, replicas=3,
             profile=dict(base=10.0, burst_rate=40.0, burst_every=2.0, burst_len=0.5),
             rate_factor=4.0, duration=8.0, width_mix=((4, 0.7), (24, 0.3)),
             width_classes=(8, 24), deadline_s=0.05, max_pending_cols=2048, seed=17,
             loss_at=100)
WIDTH_CLASSES = (64, 128, 256, 512)
HOST_SHARE_REPEATS = 5  # captured and eager forwards, interleaved
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

    # the paper's 128 x 128 blocks (a train-paper layer's shape), which the
    # wrappers launch re-tiled (kernels.retile): 64 x 64 sub-blocks here
    from repro_torch.kernels import retile
    from repro_torch.kernels.bsr_spmm import tile_for

    m, bs, bpr, n_paper = PAPER_TRAIN["m"], PAPER_TRAIN["block"], 8, PAPER_TRAIN["batch"]
    gp = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    paper = block_ell(gp, m, bs, bpr, dev)
    paper_y = torch.rand((m, n_paper), generator=gp, device=dev)
    paper_b = torch.rand((m,), generator=gp, device=dev)
    paper_dense = paper.to_dense()
    for name, kern, plain, a in (
        ("bsr_spmm", ops.bsr_spmm, bsr_spmm_plain, paper),
        ("bcsr_spmm", ops.bcsr_spmm, bcsr_spmm_plain, BlockCSRMatrix.from_bsr(paper)),
    ):
        out[name]["block128"] = {
            "shape": [m, m, n_paper], "block": [bs, bs], "stored_blocks": a.nnz_blocks(),
            "launched_block": list(retile.launch_block_shape(tile_for(n_paper), bs, bs)[:2]),
            **panel_timing(kern, plain, a, paper_dense, paper_y, paper_b,
                           stored_work(a, n_paper), spmm_work(a, n_paper))}
    del paper_dense

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


def plan_launches(cache) -> dict:
    """Per kernel, the launches the cached plans ran: each plan's captured
    forward (its per-replay launches) times its warm-ups and replays."""
    from repro_torch.kernels import ops

    want = dict.fromkeys(ops.KERNELS, 0)
    for plan in cache.plans():
        for name, k in (plan.captured_launches or {}).items():
            want[name] += k * (plan.warmups + plan.replays)
    return want


def plan_summaries(cache) -> list:
    return [{k: plan.describe()[k] for k in ("width", "route", "executable", "compiles",
                                              "warmups", "replays", "kernel_launches")}
            for plan in cache.plans()]


def measured_replay(plan) -> dict:
    """One more replay of ``plan`` (a zero panel of its width): the kernel
    nodes of its captured graph, read through libcuda
    (``plan.graph_launches``), must be the launches the capture recorded
    and the counts the wrappers' accounting added for the replay."""
    import torch

    from repro_torch.kernels import ops

    y = torch.zeros((plan.weights[0].shape[1], plan.width), device="cuda")
    before, replays = ops.launch_counts(), plan.replays
    plan.forward(y)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    counted = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    in_graph = {k: v for k, v in plan.graph_launches.items() if v}
    captured = {k: v for k, v in plan.captured_launches.items() if v}
    check(plan.replays == replays + 1 and in_graph == captured == counted,
          ("a replay's kernels, graph nodes / captured / counted", in_graph, captured, counted))
    return {"route": plan.route, "width": plan.width, "graph_kernel_nodes": in_graph,
            "counted": counted}


def check_captured(cache, counts) -> dict:
    """Every plan captured once, and the launches are the plans'
    warm-ups and replays, no more and no fewer. Returns the plans'
    summaries as served and, for one plan of each route, a replay checked
    against its graph's kernel nodes (``measured_replay``): the replays'
    share of the counts rests on what the graph holds."""
    summaries = plan_summaries(cache)
    for plan in cache.plans():
        check(plan.describe()["executable"] == "cuda-graph" and plan.compile_count == 1
              and plan.warmups == 1, plan.describe())
    check(counts == plan_launches(cache), ("launches = warm-ups + replays", counts,
                                           plan_launches(cache)))
    by_route = {plan.route: plan for plan in cache.plans()}
    return {"plans": summaries,
            "replays_measured": [measured_replay(plan) for plan in by_route.values()]}


def phase_serve(spec, *, n_inputs, use_resident, density, ref_cols, route, level,
                kernels, panel_dtype=None):
    """``run_challenge`` through an engine built here (so its plans can be
    read): routes, levels, answer set, and the launches its captured plans
    ran. Returns the phase's line, the engine and the result."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.serve import SparseDNNEngine, run_challenge

    dev = torch.device("cuda")
    weights, biases = rx.radixnet_weights(spec, device=dev)
    engine = SparseDNNEngine(weights, biases, batch_align=32, use_resident=use_resident,
                             device=dev, panel_dtype=panel_dtype)
    ops.reset_launch_counts()
    res = run_challenge(spec, n_inputs=n_inputs, density=density, engine=engine)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    check(res.routes == (route,), ("routes", res.routes))
    check(res.levels == (level,), ("levels", res.levels))
    check(res.served == n_inputs, ("served", res.served))
    for name in kernels:
        check(counts[name] > 0, (name, counts))
    captured = check_captured(engine.plan_cache, counts)
    panel = rx.radixnet_input_panel(spec.neurons, n_inputs, density=density, seed=0)
    ref_y, ref_cats = rx.radixnet_reference(spec, np.ascontiguousarray(panel[:, :ref_cols]))
    check(np.isfinite(ref_y).all(), "finite reference activations")
    check(0 < len(ref_cats) < ref_cols, ("nondegenerate answer set", len(ref_cats)))
    got = res.categories[res.categories < ref_cols]
    if panel_dtype is None:
        check(np.array_equal(got, ref_cats), (got, ref_cats))
    info = {
        "spec": [spec.neurons, spec.layers], "n_inputs": n_inputs, "density": density,
        "routes": list(res.routes), "levels": list(res.levels), "steps": res.steps,
        "width_classes": list(res.width_classes), "launches": counts, **captured,
        "seconds": res.seconds, "edge_inputs_per_sec": res.edge_inputs_per_sec,
        "categories": int(len(res.categories)), "reference_columns": ref_cols,
        "reference_categories": int(len(ref_cats)),
        "reference_categories_matched": int(len(np.intersect1d(got, ref_cats))),
    }
    return info, engine, res


def eager_forward(plan, y):
    """A layered plan's layer loop, called eagerly through ``kernel_ops``
    from this script: what the plan's captured graph replays."""
    from repro_torch.kernels import ops

    kernel = {"kernel-bcsr": ops.bcsr_spmm, "kernel-ell": ops.bsr_spmm,
              "kernel-dense": ops.semiring_matmul}
    for lp, w, b in zip(plan.layers, plan.weights, plan.biases):
        y = kernel[lp.path](w, y, b, fuse_bias_relu=True)
    return y


def wall_ms(fn) -> float:
    """Host milliseconds of ``fn`` from a synchronised start to its end on
    the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def host_share(plan, y, *, other=None) -> dict:
    """The captured ``plan.forward`` against the same layer loop called
    eagerly (and ``other``, a second eager forward of the same function,
    when given), interleaved ``HOST_SHARE_REPEATS`` times on the host
    clock, beside the kernels' CUDA-event time. The replay must give the
    eager loop's bits."""
    import torch

    got, want = plan.forward(y), eager_forward(plan, y)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "a replay gives the eager forward's bits")
    arms = {"eager": lambda: eager_forward(plan, y), "captured": lambda: plan.forward(y)}
    if other is not None:
        arms["other"] = other
    times = {name: [] for name in arms}
    for _ in range(HOST_SHARE_REPEATS):
        for name, fn in arms.items():
            times[name].append(wall_ms(fn))
    kernels_ms = gpu_time_ms(lambda: eager_forward(plan, y), per_rep=1, reps=3)
    return {
        "columns": int(y.shape[1]), "launches_per_forward": plan.kernel_launches,
        **{f"{name}_ms": t for name, t in times.items()},
        **{f"{name}_ms_median": statistics.median(t) for name, t in times.items()},
        "kernels_ms": kernels_ms,
        "replay_device_ms": gpu_time_ms(lambda: plan.forward(y), per_rep=1, reps=3),
    }


def _oracle_chunk(job):
    """The numpy oracle's final activations and categories on one chunk of
    panel columns (run in a worker process)."""
    from repro_torch.data import radixnet as rx

    neurons, layers, chunk = job
    return rx.radixnet_reference(rx.RadixNetSpec(neurons, layers), chunk)


def oracle_categories(spec, panel, chunk: int = 512) -> np.ndarray:
    """``radixnet_reference``'s categories on every column of ``panel``."""
    return oracle_forward(spec, panel, chunk)[1]


def oracle_forward(spec, panel, chunk: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """``radixnet_reference``'s (final activations, categories) on every
    column of ``panel``, chunks of columns in parallel processes (the
    oracle is one numpy gather a layer, single-threaded)."""
    import concurrent.futures
    import multiprocessing

    starts = range(0, panel.shape[1], chunk)
    jobs = [(spec.neurons, spec.layers, np.ascontiguousarray(panel[:, i:i + chunk]))
            for i in starts]
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(len(jobs), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = list(pool.map(_oracle_chunk, jobs))
    return (np.concatenate([y for y, _ in parts], axis=1),
            np.concatenate([cats + i for (_, cats), i in zip(parts, starts)]))


def serve_trace(batcher, ticks, features, *, on_tick=None) -> float:
    """Serve an arrival trace through ``batcher``: ``ticks[t]`` requests
    arrive at tick t, the next columns of ``features`` in order; one
    scheduler step a tick, then a drain. Returns the host seconds to the
    last result on the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k = 0
    for count in ticks:
        for _ in range(count):
            batcher.submit(features[k])
            k += 1
        if on_tick is not None:
            on_tick(batcher)
        batcher.step()
    batcher.drain()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def served_categories(batcher, n: int) -> np.ndarray:
    """The challenge categories of the requests the batcher completed
    (request id = panel column)."""
    import torch

    rids = sorted(batcher.stats().latencies)
    out = torch.stack([batcher.result(r) for r in rids], dim=1)
    active = np.zeros(n, bool)
    active[rids] = (out > 0).any(dim=0).cpu().numpy()
    return np.flatnonzero(active)


def continuous_batcher(spec, **engine_kw):
    """The continuous phases' engine (resident, RadiX-net ``spec``) and
    batcher (512 slots, width classes, min_fill 0, max_wait 4)."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.serve import ContinuousBatcher, SparseDNNEngine

    dev = torch.device("cuda")
    weights, biases = rx.radixnet_weights(spec, device=dev)
    engine = SparseDNNEngine(weights, biases, batch_align=32, use_resident=True, device=dev,
                             **engine_kw)
    batcher = ContinuousBatcher(engine, batch_size=512, min_fill=0.0, max_wait=4,
                                width_classes=WIDTH_CLASSES,
                                fault_injector=engine.fault_injector, clock=engine.clock)
    return engine, batcher


def trace_ticks(spec, n_requests: int, lam: float, seed: int) -> list[int]:
    """Arrivals a tick of ``poissonish_trace`` (its columns are not used:
    every request is a column of the challenge's input panel)."""
    from repro_torch.serve import poissonish_trace

    return [len(a) for a in poissonish_trace(n_requests, m=spec.neurons, lam=lam, seed=seed)]


def phase_continuous(spec, panel, ref_cats, *, n_requests, lam, seed) -> dict:
    """Continuous batching over captured plans, one per width class."""
    import torch

    from repro_torch.kernels import ops

    engine, batcher = continuous_batcher(spec)
    ticks = trace_ticks(spec, n_requests, lam, seed)
    features = torch.from_numpy(panel).to("cuda").unbind(1)
    ops.reset_launch_counts()
    seconds = serve_trace(batcher, ticks, features)
    counts = ops.launch_counts()
    stats = batcher.stats()
    check(stats.requests == n_requests and not batcher.failures, stats.summary())
    cats = served_categories(batcher, n_requests)
    check(np.array_equal(cats, ref_cats), ("continuous categories", len(cats), len(ref_cats)))
    used = sorted({r.width_class for r in stats.steps})
    check(sorted(stats.plan_recompiles_by_class) == used
          and all(v == 1 for v in stats.plan_recompiles_by_class.values()),
          ("one capture per width class", stats.plan_recompiles_by_class, used))
    check(sorted(p.width for p in engine.plan_cache.plans()) == used, plan_summaries(
        engine.plan_cache))
    captured = check_captured(engine.plan_cache, counts)
    # one miss per width class used, every other dispatch a hit: with a
    # few dozen dispatches the first-panel misses hold the rate well
    # under 1 (printed, not held to a bound)
    dispatches = len(stats.steps)
    check(stats.goodput == 1.0, stats.summary())
    check(stats.plan_cache_hit_rate == (dispatches - len(used)) / dispatches, stats.summary())
    check({r.plan_level for r in stats.steps} == {"resident"}, "resident throughout")
    return {
        "spec": [spec.neurons, spec.layers], "trace": {"n_requests": n_requests, "lam": lam,
                                                        "seed": seed, "ticks": len(ticks)},
        "batcher": {"batch_size": 512, "width_classes": list(WIDTH_CLASSES), "min_fill": 0.0,
                    "max_wait": 4},
        "summary": stats.summary(),
        "steps_by_width_class": {str(w): sum(r.width_class == w for r in stats.steps)
                                 for w in used},
        "launches": counts, **captured,
        "seconds": seconds, "edge_inputs_per_sec": spec.edges * n_requests / seconds,
        "categories": int(len(cats)), "reference_categories": int(len(ref_cats)),
    }


def phase_continuous_faults(spec, panel, ref_cats, *, n_requests, lam, seed) -> dict:
    """The continuous batcher under scheduled faults on a virtual clock."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import VirtualClock
    from repro_torch.testing import faults

    inj = faults.FaultInjector(seed=seed)
    inj.schedule(faults.SITE_PANEL_NANS, 2, count=3)
    inj.schedule(faults.SITE_STEP_TRANSIENT, 4, failures=1)
    inj.schedule(faults.SITE_PLAN_COMPILE, 6)
    clock = VirtualClock()
    engine, batcher = continuous_batcher(spec, fault_injector=inj, clock=clock,
                                         retry_backoff_s=0.05)
    ticks = trace_ticks(spec, n_requests, lam, seed)
    features = torch.from_numpy(panel).to("cuda").unbind(1)

    demoted_at = []

    def restore_later(b):  # an operator re-admits the resident level 8 ticks on
        if engine.ladder.degraded:
            demoted_at.append(b.tick)
            if b.tick >= demoted_at[0] + 8:
                engine.ladder.restore("resident", reason="operator restore", step=b.tick)

    ops.reset_launch_counts()
    seconds = serve_trace(batcher, ticks, features, on_tick=restore_later)
    counts = ops.launch_counts()
    stats = batcher.stats()
    quarantined = sorted(r for r, why in batcher.failures.items() if "quarantined" in why)
    poisoned = min(3, stats.steps[2].occupancy)  # dispatch 2's panel, 3 columns at most
    check(len(quarantined) == len(batcher.failures) == poisoned
          and set(quarantined) <= set(stats.steps[2].request_ids), batcher.failures)
    check(stats.faults.retried_steps == 1 and stats.faults.failed == 0, stats.summary())
    check(clock.sleeps == [0.05], ("backoff on the virtual clock", clock.sleeps))
    check([(e.level, e.healthy) for e in engine.ladder.events]
          == [("resident", False), ("resident", True)], engine.ladder.describe())
    levels = [r.plan_level for r in stats.steps]
    first_layered = levels.index("layered")
    check(set(levels[:first_layered]) == {"resident"} and "resident" in levels[first_layered:],
          levels)
    cats = served_categories(batcher, n_requests)
    want = np.setdiff1d(ref_cats[ref_cats < n_requests], quarantined)
    check(np.array_equal(cats, want), ("served exactly", len(cats), len(want)))
    check(stats.goodput == (n_requests - poisoned) / n_requests, stats.summary())
    captured = check_captured(engine.plan_cache, counts)
    return {
        "n_requests": n_requests, "faults_fired": [dataclasses.asdict(e) for e in inj.fired],
        "quarantined_request_ids": quarantined, "summary": stats.summary(),
        "levels": {lvl: levels.count(lvl) for lvl in sorted(set(levels))},
        "ladder": engine.ladder.describe(), "virtual_sleeps": clock.sleeps,
        "launches": counts, **captured, "seconds": seconds,
    }


def phase_serve_bf16(spec, f32_res) -> dict:
    """``run_challenge`` on bf16 activation panels: the output against the
    plain version in bf16, categories against the f32 run's, and the bf16
    launch's time beside the f32 one's."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_mlp import fused_mlp_plain

    info, engine, res = phase_serve(spec, n_inputs=f32_res.n_inputs, use_resident=None,
                                    density=0.3, ref_cols=512, route="fused",
                                    level="resident", kernels=("fused_mlp_forward",),
                                    panel_dtype="bfloat16")
    (plan,) = engine.plan_cache.plans()
    check(plan.key.tuned == "panel_dtype=bfloat16", plan.key)
    y = torch.from_numpy(np.ascontiguousarray(
        rx.radixnet_input_panel(spec.neurons, f32_res.n_inputs, density=0.3,
                                seed=0)[:, :plan.width])).to("cuda")
    got = plan.forward(y)
    want = fused_mlp_plain(*plan.stacked, y, panel_dtype="bfloat16")
    torch.cuda.synchronize()
    err = errors(got, want)
    check(err["max_abs_err"] <= STACK_RTOL * float(want.abs().max()), ("bf16 stack", err))
    agree = f32_res.n_inputs - len(np.setxor1d(res.categories, f32_res.categories))
    sw, sb = plan.stacked
    return {
        **info, **err, "check": "max|kernel - plain(bf16)| <= 1e-4 max|plain(bf16)|",
        "categories_agreeing_with_f32": int(agree),
        "categories_f32": int(len(f32_res.categories)),
        "kernel_ms": {"bfloat16": gpu_time_ms(lambda: ops.fused_mlp_forward(
                          sw, sb, y, panel_dtype="bfloat16"), per_rep=1, reps=3),
                      "float32": gpu_time_ms(lambda: ops.fused_mlp_forward(sw, sb, y),
                                             per_rep=1, reps=3)},
        "edge_inputs_per_sec_f32": f32_res.edge_inputs_per_sec,
    }


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
    captured = check_captured(engine.plan_cache, counts)
    cats = np.flatnonzero(active.cpu().numpy())
    check(np.array_equal(cats, ref_cats), ("dense categories", len(cats), len(ref_cats)))
    (plan,) = engine.plan_cache.plans()
    return {
        "spec": [spec.neurons, spec.layers], "n_inputs": n_inputs, "routes": routes,
        "layer_paths": ["kernel-dense"], "steps": len(stats), "launches": counts, **captured,
        "seconds": seconds, "inputs_per_sec": n_inputs / seconds,
        "edge_inputs_per_sec": spec.edges * n_inputs / seconds,
        "grid_steps_per_panel": stats[0]["grid_steps"],
        "categories": int(len(cats)), "reference_categories": int(len(ref_cats)),
        "host_share": host_share(plan, y0[:, :panel_width].contiguous()),
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


def phase_graphblas(spec, panel, ref_cats, layered_plan, *, m=SKEWED_M, block=16,
                    total_blocks=SKEWED_BLOCKS, skew=SKEWED_SKEW, seed=SKEWED_SEED, feat=256,
                    rounds=2, bf_cap=64) -> dict:
    """gnn_arm at card scale, one BFS step, and the three-call DNN, the
    last timed on a 512-column panel against ``layered_plan`` (the same
    network's captured layered plan) and its eager layer loop."""
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
    y = torch.from_numpy(np.ascontiguousarray(panel[:, :layered_plan.width])).to(dev)
    three_call = lambda: dnn.dnn_forward(weights, biases, y, fused=False)  # noqa: E731
    share = host_share(layered_plan, y, other=three_call)
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
                       "categories": int(len(cats)), "matches_reference": True,
                       "host_share": {**share, "three_call_ms": share.pop("other_ms"),
                                      "three_call_ms_median": share.pop("other_ms_median")}},
    }


def block_ell(gen, m: int, bs: int, bpr: int, dev):
    """An m x m ELL matrix of bs x bs blocks, ``bpr`` random block-columns a
    block-row, values U[0, 1) / (bpr · bs) (positive: no cancellation)."""
    import torch

    from repro_torch.sparse.bsr import BlockSparseMatrix

    nrb = m // bs
    cols = torch.rand((nrb, nrb), generator=gen, device=dev).argsort(dim=1)[:, :bpr]
    blocks = torch.rand((nrb, bpr, bs, bs), generator=gen, device=dev) / (bpr * bs)
    return BlockSparseMatrix(blocks, cols.sort(dim=1).values.int().contiguous(),
                             torch.ones((nrb, bpr), dtype=torch.bool, device=dev), (m, m),
                             (bs, bs))


def he_values(w, gen, fan_in: int):
    """``w`` with each nonzero stored weight redrawn U(-a, a), a = sqrt(6 /
    fan_in) (He scale: ReLU stacks keep their activations' scale)."""
    import torch

    from repro_torch.core.dnn import values_of, with_values

    v = values_of(w)
    a = (6.0 / fan_in) ** 0.5
    u = torch.rand(v.shape, generator=gen, device=v.device)
    return with_values(w, (v != 0) * (u * 2 - 1) * a)


def rel_norm_err(got, want) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def relu_masks(weights, biases, y0, transpose_plans, *, use_kernel: bool) -> list:
    """Each layer's ReLU mask (``out > 0``) in the kernels' or the plain forward."""
    import torch

    from repro_torch.core import dnn

    masks, y = [], y0
    with torch.no_grad():
        for w, b, tp in zip(weights, biases, transpose_plans):
            y = (dnn.dnn_layer_trainable(w, y, b, transpose_plan=tp) if use_kernel
                 else dnn.dnn_layer(w, y, b))
            masks.append(y > 0)
    return masks


def grads_on_masks(weights, biases, y0, targets, masks):
    """Loss and gradients (values, then biases) of the plain forward with
    each layer's ReLU mask fixed to ``masks``: the same piecewise-linear
    function as the forward that made the masks, at the same point."""
    import torch

    from repro_torch.core import dnn
    from repro_torch.sparse import ops as sparse_ops
    from repro_torch.sparse.bcsr import BlockCSRMatrix
    from repro_torch.sparse.bsr import BlockSparseMatrix

    leaves = [dnn.values_of(w).detach().requires_grad_() for w in weights]
    bleaves = [b.detach().requires_grad_() for b in biases]
    y = y0
    for w, v, b, m in zip(weights, leaves, bleaves, masks):
        w = dnn.with_values(w, v)
        z = (sparse_ops.bcsr_matmul(w, y) if isinstance(w, BlockCSRMatrix)
             else sparse_ops.bsr_matmul(w, y) if isinstance(w, BlockSparseMatrix) else w @ y)
        y = torch.where(m, z + b[:, None], torch.zeros((), device=y.device))
    loss = 0.5 * torch.mean((y - targets) ** 2)
    return loss.detach(), torch.autograd.grad(loss, leaves + bleaves)


def train_cell(weights, biases, y0, targets, opt, steps: int) -> dict:
    """A differentiable plan, the first step's gradients against the plain
    versions, then ``steps`` steps of ``make_sparse_train_step`` (launches
    counted over them), forward and backward timed apart."""
    import torch

    from repro_torch.core import dnn
    from repro_torch.kernels import ops
    from repro_torch.plan import build_plan
    from repro_torch.sparse.bcsr import (
        BlockCSRMatrix,
        reset_transpose_sort_count,
        transpose_sort_count,
    )
    from repro_torch.sparse.bsr import BlockSparseMatrix
    from repro_torch.train import (
        grad_sparsity_preserved,
        init_sparse_mlp_state,
        make_sparse_train_step,
    )

    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32, "no TF32 in the backward products")
    n = y0.shape[1]
    n_ell = sum(isinstance(w, BlockSparseMatrix) for w in weights)
    n_csr = sum(isinstance(w, BlockCSRMatrix) for w in weights)
    reset_transpose_sort_count()
    t0 = time.perf_counter()
    plan = build_plan(weights, biases, n, differentiable=True)
    plan_seconds = time.perf_counter() - t0
    sorts = transpose_sort_count()
    sparse = (BlockCSRMatrix, BlockSparseMatrix)
    check(sorts == len({id(w) for w in weights if isinstance(w, sparse)}),
          ("one sort per sparse matrix at plan build", sorts))
    check(plan.route in ("layered", "xla") and not plan.is_fused_route, plan.route)

    # the first step's gradients against the plain versions on the card:
    # on the kernels' ReLU masks (checked), and on the plain forward's own
    # (printed, with the mask entries the two forwards disagree on)
    loss_k, (dw_k, db_k) = dnn.dnn_value_and_grad(weights, biases, y0, targets, plan=plan)
    got = [dnn.values_of(g) for g in dw_k] + list(db_k)
    masks = relu_masks(weights, biases, y0, plan.transpose_plans, use_kernel=True)
    loss_m, want = grads_on_masks(weights, biases, y0, targets, masks)
    own = relu_masks(weights, biases, y0, plan.transpose_plans, use_kernel=False)
    flips = [int((a != b).sum()) for a, b in zip(masks, own)]
    del masks, own
    loss_p, (dw_p, db_p) = dnn.dnn_value_and_grad(weights, biases, y0, targets, use_kernel=False)
    torch.cuda.synchronize()
    plain = [dnn.values_of(g) for g in dw_p] + list(db_p)
    grad_err = max(rel_norm_err(a, b) for a, b in zip(got, want))
    grad_max_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                       for a, b in zip(got, want))
    own_err = max(rel_norm_err(a, b) for a, b in zip(got, plain))
    loss_err = abs(float(loss_k) - float(loss_m)) / abs(float(loss_m))
    check(all(bool(torch.isfinite(a).all()) for a in got), "finite gradients")
    check(grad_err <= GRAD_RTOL, ("gradients vs plain on the kernels' masks", grad_err))
    check(loss_err <= GRAD_RTOL, ("loss vs plain", loss_err))
    sparsity = grad_sparsity_preserved(weights, dw_k)
    check(sparsity, "gradients outside the stored pattern")
    del dw_p, db_p, got, want, plain

    # forward alone (the graph built), then forward + backward, timed
    def leaves():
        ws = [dnn.with_values(w, dnn.values_of(w).detach().requires_grad_()) for w in weights]
        return ws, [b.detach().requires_grad_() for b in biases]

    def forward():
        ws, bs = leaves()
        out = dnn.dnn_forward_trainable(ws, bs, y0, plan=plan)
        return 0.5 * torch.mean((out - targets) ** 2)

    ops.reset_launch_counts()
    forward()
    torch.cuda.synchronize()
    fwd_counts = ops.launch_counts()
    fwd_times, vag_times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = forward()
        torch.cuda.synchronize()
        fwd_times.append(time.perf_counter() - t0)
        del loss
        t0 = time.perf_counter()
        dnn.dnn_value_and_grad(weights, biases, y0, targets, plan=plan)
        torch.cuda.synchronize()
        vag_times.append(time.perf_counter() - t0)

    # the main path: steps of the sparse train step, counted
    state = init_sparse_mlp_state(weights, biases, opt)
    step = make_sparse_train_step(opt, plan=plan)
    batch = {"y0": y0, "targets": targets}
    losses, step_times = [], []
    ops.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    counts = ops.launch_counts()
    shapes = ops.launched_block_shapes()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], ("loss falls", losses))
    check(transpose_sort_count() == sorts, ("no sort after the plan's build", sorts,
                                            transpose_sort_count()))
    # dX launches, a bcsr_spmm on the cached transpose of every sparse layer
    # whose input needs a gradient: all but a first layer (the input panel
    # is data)
    n_bwd = n_ell + n_csr - int(isinstance(weights[0], sparse))
    fwd = {k: fwd_counts[k] for k in ("bsr_spmm", "bcsr_spmm")}
    per_step = {k: counts[k] / steps for k in ("bsr_spmm", "bcsr_spmm")}
    bwd = {k: per_step[k] - fwd[k] for k in fwd}
    check(fwd == {"bsr_spmm": n_ell, "bcsr_spmm": n_csr}, ("forward launches", fwd))
    check(bwd == {"bsr_spmm": 0, "bcsr_spmm": n_bwd}, ("backward launches", bwd))
    check(all(v == 0 for k, v in counts.items() if k not in fwd), counts)
    return {
        "layers": len(weights), "ell_layers": n_ell, "bcsr_layers": n_csr,
        "route": plan.route, "paths": sorted({lp.path for lp in plan.layers}),
        "columns": n, "plan_seconds": plan_seconds,
        "losses": losses, "first_step_loss_rel_err": loss_err,
        "grad_rel_err": grad_err, "grad_check": f"per layer tensor ||kernel - plain|| <= "
                                                f"{GRAD_RTOL} ||plain||, the kernels' ReLU masks",
        "grad_max_rel_err": grad_max_err,
        "own_masks": {"grad_rel_err": own_err, "relu_mask_flips": sum(flips),
                      "layers_with_flips": [i for i, f in enumerate(flips) if f],
                      "loss_rel_err": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))},
        "grad_sparsity_preserved": sparsity,
        "transpose_sorts": {"after_plan_build": sorts, "after_steps": transpose_sort_count()},
        "launches": counts, "launches_per_step": {"forward": fwd, "backward": bwd},
        "launched_block_shapes": {k: [list(s) for s in v] for k, v in shapes.items()},
        "forward_ms": 1e3 * statistics.median(fwd_times),
        "forward_backward_ms": 1e3 * statistics.median(vag_times),
        "backward_ms": 1e3 * (statistics.median(vag_times) - statistics.median(fwd_times)),
        "step_ms": 1e3 * statistics.median(step_times[1:]),
        "step_ms_all": [1e3 * x for x in step_times],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def phase_train_radixnet(neurons: int, layers: int, columns: int, steps: int, lr: float) -> dict:
    """The challenge topology at full width, trained: RadiX-net's stored
    blocks with seeded He-scale values (the challenge's own 1/16 weights
    double a live column every layer, past f32's range for a squared
    loss), the stride-1 phase as block-CSR, a Philox input panel."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.plan.layout import to_preferred_layout
    from repro_torch.train import sgd

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    spec = rx.RadixNetSpec(neurons, layers)
    phases, _ = rx.radixnet_weights(spec, device=dev)
    relaid = {}
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    weights = []
    for w in phases:
        if id(w) not in relaid:
            relaid[id(w)] = to_preferred_layout(w)
        weights.append(he_values(relaid[id(w)], gen, fan_in=32))
    biases = [torch.zeros(neurons, device=dev) for _ in weights]
    y0 = torch.from_numpy(rx.radixnet_input_panel(neurons, columns, density=0.3, seed=0)).to(dev)
    targets = torch.rand((neurons, columns), generator=gen, device=dev)
    info = train_cell(weights, biases, y0, targets, sgd(lr), steps)
    return {"spec": [neurons, layers], "optimizer": f"sgd(lr={lr}, momentum=0.9)", **info}


def phase_train_paper(m: int, layers: int, inverse_sparsity: int, block: int, batch: int,
                      steps: int, lr: float) -> dict:
    """The paper's MLP at a Fig. 5 grid point (graphblas_mlp.make_config(m,
    layers, inverse_sparsity, block)): seeded dense weights block-pruned to
    ELL, every other layer re-laid as block-CSR; a served forward through a
    layered plan (128 x 128 blocks, re-tiled by the wrappers) against the
    plain version; then AdamW steps."""
    import torch

    from repro_torch.core import dnn, pruning
    from repro_torch.kernels import ops
    from repro_torch.plan import build_plan
    from repro_torch.sparse.bcsr import BlockCSRMatrix

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    bpr = max(1, round((m // block) / inverse_sparsity))
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    t0 = time.perf_counter()
    weights = []
    for i in range(layers):
        dense = torch.randn((m, m), generator=gen, device=dev) * (2.0 / (bpr * block)) ** 0.5
        w = pruning.block_prune(dense, (block, block), bpr)
        del dense
        weights.append(BlockCSRMatrix.from_bsr(w) if i % 2 else w)
    biases = [torch.full((m,), 0.01, device=dev) for _ in weights]
    build_seconds = time.perf_counter() - t0
    y0 = torch.rand((m, batch), generator=gen, device=dev)
    targets = torch.rand((m, batch), generator=gen, device=dev)

    # serving: the 128 x 128 stack through a layered plan, no grad
    plan = build_plan(weights, biases, batch)
    check(plan.route == "layered", plan.route)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = plan.forward(y0)
    torch.cuda.synchronize()
    serve_counts, serve_shapes = ops.launch_counts(), ops.launched_block_shapes()
    want = dnn.dnn_forward(weights, biases, y0)
    serve_err = errors(got, want)
    check(columns_within(got, want, STACK_RTOL, STACK_ATOL), ("served forward", serve_err))
    check(serve_counts["bsr_spmm"] + serve_counts["bcsr_spmm"] == layers, serve_counts)
    check(all(tuple(s) != (block, block) for v in serve_shapes.values() for s in v), serve_shapes)

    from repro_torch.train import adamw

    info = train_cell(weights, biases, y0, targets, adamw(lr), steps)
    check(all(tuple(s) != (block, block) for v in info["launched_block_shapes"].values()
              for s in v), info["launched_block_shapes"])
    return {
        "config": {"m": m, "num_layers": layers, "inverse_sparsity": inverse_sparsity,
                   "block": block, "blocks_per_row": bpr, "batch": batch},
        "values_mb_per_layer": m // block * bpr * block * block * 4 / 2 ** 20,
        "build_seconds": build_seconds, "optimizer": f"adamw(lr={lr})",
        "serve": {**serve_err, "launches": serve_counts,
                  "launched_block_shapes": {k: [list(s) for s in v]
                                            for k, v in serve_shapes.items()}},
        **info,
    }


def _skewed_stack(specs, skew: float, block: int, dev):
    """The reference tune arm's skewed stack (benchmarks/kernel_bench.py
    ``tune_arm``): ``random_skewed`` block-CSR topologies handed over as ELL."""
    import torch

    from repro_torch.sparse.bcsr import BlockCSRMatrix

    ws = [BlockCSRMatrix.random_skewed(i, shape, (block, block), total, skew=skew,
                                       device=dev).to_bsr()
          for i, (shape, total) in enumerate(specs)]
    return ws, [torch.zeros(w.shape[0], device=dev) for w in ws]


def sweep_record(rec: dict) -> dict:
    keys = ("token", "route", "grid_steps", "block_work", "vmem_bytes", "wall_s",
            "max_abs_err", "ok", "selected", "error")
    out = {k: rec[k] for k in keys if k in rec}
    if "vmem_bytes" in out:
        out["smem_bytes"] = out.pop("vmem_bytes")
    return out


def phase_tune(skewed, radix) -> tuple[dict, object]:
    """The autotuner on the card: the reference tune arm's skewed stack
    (``layout=bcsr`` must win, as in the reference) and RadiX-net at the
    challenge sizes on the {0, 1} panel. Every candidate's bill and time
    is printed; the winners go into one ``TuningTable``, saved and loaded
    back. Returns the line and the table."""
    import tempfile

    import torch

    from repro_torch import plan as P
    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_mlp import SMEM_LIMIT_BYTES, fused_mlp_smem_bytes
    from repro_torch.tune import (
        TunedConfig,
        TuningTable,
        default_candidates,
        sweep_stack,
        tune_stack,
    )

    dev = torch.device("cuda")
    table = TuningTable()
    ops.reset_launch_counts()

    ws, bs = _skewed_stack(skewed["specs"], skewed["skew"], skewed["block"], dev)
    width = skewed["width"]
    winner, records = sweep_stack(ws, bs, width, reps=skewed["reps"])
    by_token = {r["token"]: r for r in records}
    win, default = by_token[winner.token()], by_token["default"]
    check(winner.token() == "layout=bcsr", ("skewed winner", winner.token()))
    check(win["grid_steps"] < default["grid_steps"]
          and win["block_work"] < default["block_work"], (win, default))
    check(not any("error" in r for r in records), records)
    probe = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (ws[0].shape[1], width)).astype(np.float32)).to(dev)
    want = P.build_plan(ws, bs, width).forward(probe)
    got = P.build_plan(ws, bs, width, tuned=winner).forward(probe)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30))[want != 0].max())
    check(bool(((got - want).abs() <= 1e-6 * want.abs()).all()), ("tuned vs default", rel))
    tune_stack(ws, bs, width, table=table, sweep=(winner, records))
    skewed_line = {"specs": [[list(sh), t] for sh, t in skewed["specs"]], "skew": skewed["skew"],
                   "width": width, "winner": winner.token(),
                   "tuned_vs_default_max_rel_err": rel, "check": "|tuned - default| <= 1e-6 |default|",
                   "candidates": [sweep_record(r) for r in records]}

    radix_lines = []
    for neurons, density in radix["sizes"]:
        spec = rx.RadixNetSpec(neurons, radix["layers"])
        weights, biases = rx.radixnet_weights(spec, block_size=radix["block"], device=dev)
        n = radix["width"]
        probe = torch.from_numpy(np.ascontiguousarray(rx.radixnet_input_panel(
            neurons, n, density=density, seed=0))).to(dev)
        f32_bytes = fused_mlp_smem_bytes(neurons, None, radix["block"])
        budget = min(f32_bytes - 1, SMEM_LIMIT_BYTES)
        cands = default_candidates(block_ns=(None, 8), vmem_limits=(None, budget))
        t0 = time.perf_counter()
        winner, records = sweep_stack(weights, biases, n, candidates=cands, reps=radix["reps"],
                                      probe=probe)
        sweep_seconds = time.perf_counter() - t0
        # no candidate here is one the port refuses by design
        check(not any("error" in r for r in records), [r for r in records if "error" in r])
        timed = [r for r in records if r["ok"]]
        fastest = min(timed, key=lambda r: r["wall_s"])
        tune_stack(weights, biases, n, table=table, sweep=(winner, records))
        radix_lines.append({
            "spec": [neurons, radix["layers"]], "width": n, "density": density,
            "f32_resident_smem_bytes": f32_bytes,
            "budget_candidate": budget, "winner": winner.token(),
            "winner_route": next(r for r in records if r["selected"])["route"],
            "fastest_measured": fastest["token"],
            "selected_is_fastest": fastest["selected"],
            "sweep_seconds": sweep_seconds,
            "candidates": [sweep_record(r) for r in records]})
        del weights, biases
    counts = ops.launch_counts()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "table.json")
        table.save(path)
        loaded = TuningTable.load(path)
        table_bytes = os.path.getsize(path)
    check(loaded.entries == table.entries and len(loaded) == 1 + len(radix["sizes"]),
          "the tuning table round-trips")
    check(all(loaded.lookup(k.split(":")[0], backend="cuda") is not None for k in loaded.entries),
          list(loaded.entries))
    check(isinstance(loaded.lookup(next(iter(loaded.entries)).split(":")[0], backend="cuda"),
                     TunedConfig), "lookup")
    return {"skewed": skewed_line, "radix": radix_lines, "table_entries": len(loaded),
            "table_bytes": table_bytes, "launches": counts}, loaded


def phase_serve_tuned(sizes, layers: int, table, *, n_inputs: int, ref_cols: int) -> dict:
    """``run_challenge(spec, tuning_table=table)`` on all ``n_inputs``
    inputs at each size: the route and launches of the table's winner, its
    answer set (f32 panels: equal to the numpy oracle on ``ref_cols``
    columns; bf16 panels: a panel bit-identical to ``fused_mlp_plain`` at
    the same config, the disagreeing categories printed); then a short run
    through an engine built with the same table, whose captured plans are
    held to their launches as the serving phases hold theirs."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_mlp import fused_mlp_plain
    from repro_torch.plan import topology_fingerprint
    from repro_torch.serve import SparseDNNEngine, run_challenge

    dev = torch.device("cuda")
    lines = []
    for neurons, density in sizes:
        spec = rx.RadixNetSpec(neurons, layers)
        weights, biases = rx.radixnet_weights(spec, device=dev)
        tuned = table.lookup(topology_fingerprint(weights), backend="cuda")
        check(tuned is not None, ("a table hit", spec))
        record = table.record(topology_fingerprint(weights), backend="cuda")
        kernel = {"fused": "fused_mlp_forward", "fused-tiled": "fused_mlp_tiled_forward"}[
            record["route"]]
        ops.reset_launch_counts()
        res = run_challenge(spec, n_inputs=n_inputs, density=density, tuning_table=table)
        counts = ops.launch_counts()
        torch.cuda.synchronize()
        check(res.routes == (record["route"],) and res.levels == ("resident",), res.routes)
        check(res.served == n_inputs, res.served)
        # the warm-up captures the one plan, every timed panel replays it
        check(counts[kernel] == res.steps + 1
              and sum(counts.values()) == counts[kernel], counts)

        panel = rx.radixnet_input_panel(spec.neurons, n_inputs, density=density, seed=0)
        ref_panel = np.ascontiguousarray(panel[:, :ref_cols])
        ref_cats = oracle_categories(spec, ref_panel, chunk=64)
        check(0 < len(ref_cats) < ref_cols, ("nondegenerate answer set", len(ref_cats)))
        got_cats = res.categories[res.categories < ref_cols]
        engine = SparseDNNEngine(weights, biases, batch_align=32, tuning_table=table, device=dev)
        check(engine.tuned == tuned, (engine.tuned, tuned))
        ops.reset_launch_counts()
        run_challenge(spec, n_inputs=4 * 512, density=density, engine=engine)
        short_counts = ops.launch_counts()
        torch.cuda.synchronize()
        captured = check_captured(engine.plan_cache, short_counts)
        (plan,) = engine.plan_cache.plans()
        check(plan.key.tuned == tuned.token() and plan.route == record["route"], plan.describe())
        line = {"spec": [spec.neurons, spec.layers], "density": density, "tuned": tuned.token(),
                "route": record["route"], "n_inputs": n_inputs, "steps": res.steps,
                "launches": counts, "seconds": res.seconds,
                "edge_inputs_per_sec": res.edge_inputs_per_sec,
                "categories": int(len(res.categories)), "reference_columns": ref_cols,
                "reference_categories": int(len(ref_cats)),
                "reference_categories_matched": int(len(np.intersect1d(got_cats, ref_cats))),
                "engine_run": {"launches": short_counts, **captured}}
        if tuned.panel_dtype == "bfloat16":
            # RadiX-net's sums of bf16 panel values times 1/16 are exact in
            # f32, so the kernel and the plain version agree to the bit
            y = torch.from_numpy(np.ascontiguousarray(panel[:, :plan.width])).to(dev)
            out = plan.forward(y)
            want = fused_mlp_plain(*plan.stacked, y, panel_dtype="bfloat16")
            torch.cuda.synchronize()
            check(torch.equal(out, want), ("bf16 panel vs plain", errors(out, want)))
            line["bf16_panel_max_abs_err"] = float((out - want).abs().max())
            line["categories_disagreeing_with_oracle"] = int(
                len(np.setxor1d(got_cats, ref_cats)))
        else:
            check(np.array_equal(got_cats, ref_cats), ("categories", got_cats, ref_cats))
        lines.append(line)
        del weights, biases, engine
    return {"runs": lines,
            "launches": {k: sum(ln["launches"][k] + ln["engine_run"]["launches"][k]
                                for ln in lines) for k in lines[0]["launches"]}}


def phase_train_resilient(neurons: int, layers: int, columns: int, lr: float, steps: int,
                          ckpt_interval: int, nan_step: int, kill_step: int) -> dict:
    """Resilient training at full width: RADIX_TRAIN's network (RadiX-net's
    stored blocks, He-scale values, a differentiable plan), a clean run,
    a run with a NaN loss at ``nan_step`` and a run stopped at
    ``kill_step`` and resumed; both must give the clean run's losses bit
    for bit. Checkpoints go to a temporary directory."""
    import tempfile

    import torch

    from repro_torch.core.dnn import values_of
    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.plan import build_plan
    from repro_torch.plan.layout import to_preferred_layout
    from repro_torch.testing import SITE_TRAIN_NAN_LOSS, FaultInjector
    from repro_torch.train import (
        checkpoint,
        init_sparse_mlp_state,
        run_resilient_training,
        sgd,
        validate_sparse_state,
    )

    dev = torch.device("cuda")
    spec = rx.RadixNetSpec(neurons, layers)
    phases, _ = rx.radixnet_weights(spec, device=dev)
    relaid, weights = {}, []
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    for w in phases:
        if id(w) not in relaid:
            relaid[id(w)] = to_preferred_layout(w)
        weights.append(he_values(relaid[id(w)], gen, fan_in=32))
    biases = [torch.zeros(neurons, device=dev) for _ in weights]
    panel = torch.from_numpy(rx.radixnet_input_panel(neurons, columns * steps, density=0.3,
                                                     seed=0)).to(dev)

    def batch_fn(step):
        g = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 1 + step)
        return {"y0": panel[:, step * columns:(step + 1) * columns],
                "targets": torch.rand((neurons, columns), generator=g, device=dev)}

    plan = build_plan(weights, biases, columns, differentiable=True)
    state = init_sparse_mlp_state(weights, biases, sgd(lr))
    kw = dict(ckpt_interval=ckpt_interval, plan=plan, device=dev)
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        _, clean = run_resilient_training(state, batch_fn, sgd(lr), steps,
                                          os.path.join(d, "clean"), **kw)
        clean_seconds = time.perf_counter() - t0
        inj = FaultInjector()
        inj.schedule(SITE_TRAIN_NAN_LOSS, nan_step)
        t0 = time.perf_counter()
        _, faulted = run_resilient_training(state, batch_fn, sgd(lr), steps,
                                            os.path.join(d, "nan"), fault_injector=inj, **kw)
        faulted_seconds = time.perf_counter() - t0
        kill_dir = os.path.join(d, "kill")
        _, part = run_resilient_training(state, batch_fn, sgd(lr), kill_step, kill_dir, **kw)
        final, rest = run_resilient_training(state, batch_fn, sgd(lr), steps, kill_dir, **kw)
        counts = ops.launch_counts()
        torch.cuda.synchronize()
        losses = [clean["losses"][i] for i in range(steps)]
        check(all(np.isfinite(losses)), ("finite losses", losses))
        check(faulted["skipped"] == [nan_step] and len(faulted["restarts"]) == 1, faulted)
        check(faulted["losses"] == clean["losses"], ("NaN fault replay", faulted["losses"]))
        check(rest["start_step"] == kill_step
              and {**part["losses"], **rest["losses"]} == clean["losses"],
              ("kill and resume", part["losses"], rest["losses"]))
        check(counts["bsr_spmm"] > 0 and counts["bcsr_spmm"] > 0, counts)
        # the checkpoint itself: bytes, save and restore times, and a
        # restored state validated on the card
        ckpt = os.path.join(d, "timing")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpoint.save(ckpt, steps, final)
        save_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, _ = checkpoint.restore(ckpt, final)
        torch.cuda.synchronize()
        restore_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        validate_sparse_state(restored)
        validate_seconds = time.perf_counter() - t0
        check(all(values_of(w).device.type == "cuda" and torch.equal(values_of(w), values_of(v))
                  for w, v in zip(restored.weights, final.weights)),
              "restored on the card, bit for bit")
        ckpt_bytes = os.path.getsize(os.path.join(path, "arrays.npz"))
    return {
        "spec": [neurons, layers], "columns": columns, "steps": steps,
        "optimizer": f"sgd(lr={lr}, momentum=0.9)", "ckpt_interval": ckpt_interval,
        "losses": losses, "nan_step": nan_step, "skipped": faulted["skipped"],
        "restarts": faulted["restarts"], "kill_step": kill_step,
        "replays_bit_identical": {"nan_fault": True, "kill_and_resume": True},
        "clean_seconds": clean_seconds, "faulted_seconds": faulted_seconds,
        "checkpoint_bytes": ckpt_bytes, "save_seconds": save_seconds,
        "restore_seconds": restore_seconds, "validate_seconds": validate_seconds,
        "launches": counts,
    }


def sharded_layer_times(plan, y) -> dict:
    """One sparse layer of a sharded plan, eager, on the card: its S
    ``bcsr_spmm`` launches (``layer_partials``) against the partial
    panels' sum and epilogue (``sum_and_relu``), CUDA events; the heaviest
    layer (most stored blocks)."""
    from repro_torch.plan.sharded import sum_and_relu

    i, lp = max(enumerate(plan.layers), key=lambda e: sum(e[1].nnz_per_shard))
    b = plan.biases[i]
    parts = plan.layer_partials(i, y)
    spmm_ms = gpu_time_ms(lambda: plan.layer_partials(i, y), per_rep=2, reps=3)
    sum_ms = gpu_time_ms(lambda: sum_and_relu(parts, b), per_rep=2, reps=3)
    works = [spmm_work(local, y.shape[1]) for local in lp.shards]
    spmm_bound, spmm_by = bound(sum(w[0] for w in works), sum(w[1] for w in works))
    # the function reads the S partial panels and the bias once and writes
    # the output once: S - 1 adds, the bias add and the ReLU an entry
    m, n = y.shape
    sum_bound, sum_by = bound(4.0 * ((len(parts) + 1) * m * n + m), (len(parts) + 1) * m * n)
    return {"layer": i, "nnz_per_shard": list(lp.nnz_per_shard), "spmm_ms": spmm_ms,
            "spmm_bound_ms": spmm_bound, "spmm_bound_by": spmm_by,
            "partial_sum_ms": sum_ms, "partial_sum_bound_ms": sum_bound,
            "partial_sum_bound_by": sum_by, "partial_sum_share": sum_ms / (spmm_ms + sum_ms)}


def sharded_layer_checks(plan, unsharded, y0) -> dict:
    """The sharded forward layer by layer, eager, on the card: at the first
    layer of each distinct partition, every shard's ``bcsr_spmm`` (no
    epilogue) against ``bcsr_spmm_plain`` on the same sub-segment and
    panel, and the summed layer against the plain UNSHARDED layer
    (``unsharded[i]``, bias and ReLU fused), both within ``SPMM_RTOL`` /
    ``SPMM_ATOL``; the walk's output must be the plan's own forward."""
    import torch

    from repro_torch.kernels.bcsr_spmm import bcsr_spmm_plain
    from repro_torch.plan.sharded import sum_and_relu

    seen, checked = set(), []
    part_err = layer_err = 0.0
    y = y0
    for i, (lp, b) in enumerate(zip(plan.layers, plan.biases)):
        if id(lp.sharded) in seen:
            y = plan.layer_forward(i, y)
            continue
        seen.add(id(lp.sharded))
        parts = plan.layer_partials(i, y)
        for local, part in zip(lp.shards, parts):
            want = bcsr_spmm_plain(local, y, fuse_bias_relu=False)
            torch.testing.assert_close(part, want, rtol=SPMM_RTOL, atol=SPMM_ATOL)
            part_err = max(part_err, float((part - want).abs().max()))
        out = sum_and_relu(parts, b)
        want = bcsr_spmm_plain(unsharded[i], y, b, fuse_bias_relu=True)
        torch.testing.assert_close(out, want, rtol=SPMM_RTOL, atol=SPMM_ATOL)
        layer_err = max(layer_err, float((out - want).abs().max()))
        checked.append(i)
        del parts, want
        y = out
    check(torch.equal(y, plan._eager(y0)), "the layer walk is the plan's forward")
    return {"layers_checked": checked, "shard_max_abs_err": part_err,
            "layer_max_abs_err": layer_err,
            "check": "each shard's launch vs bcsr_spmm_plain on its sub-segment, and the "
                     "summed layer vs the plain unsharded layer: |kernel - plain| <= "
                     f"{SPMM_RTOL} |plain| + {SPMM_ATOL}"}


def phase_sharded(neurons, layers, shards, n_inputs, density, ref_cols) -> dict:
    """``run_challenge(spec, mesh=make_row_blocks_mesh(shards))`` on the one
    card: route and level ``sharded``, ``bcsr_spmm`` launches counted as
    the captured graph's kernel nodes, per-shard nnz and bills, categories
    against the unsharded engine's on every input and the numpy oracle's
    on ``ref_cols``; then a shard failure at dispatch 1."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_row_blocks_mesh
    from repro_torch.plan import stack_grid_steps
    from repro_torch.serve import SparseDNNEngine, run_challenge
    from repro_torch.sparse import BlockCSRMatrix
    from repro_torch.testing import SITE_SHARD_FAILURE, FaultInjector

    dev = torch.device("cuda")
    spec = rx.RadixNetSpec(neurons, layers)
    t0 = time.perf_counter()
    weights, biases = rx.radixnet_weights(spec, device=dev)
    weights_seconds = time.perf_counter() - t0
    mesh = make_row_blocks_mesh(shards)
    engine = SparseDNNEngine(weights, biases, batch_align=32, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = run_challenge(spec, n_inputs=n_inputs, density=density, engine=engine)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(res.routes == ("sharded",) and res.levels == ("sharded",), (res.routes, res.levels))
    check(res.served == n_inputs, res.served)
    (plan,) = engine.plan_cache.plans()
    captured = check_captured(engine.plan_cache, counts)
    check(plan.captured_launches == {**dict.fromkeys(ops.KERNELS, 0),
                                     "bcsr_spmm": shards * layers}, plan.captured_launches)
    check(plan.imbalance() <= 1.10, ("imbalance", plan.imbalance()))
    relaid = {}
    for w in weights:
        relaid.setdefault(id(w), BlockCSRMatrix.from_bsr(w))
    unsharded_bill = stack_grid_steps([relaid[id(w)] for w in weights], plan.width)
    check(plan.grid_steps == sum(plan.grid_steps_per_shard) == unsharded_bill,
          ("bills", plan.grid_steps_per_shard, unsharded_bill))
    panel = rx.radixnet_input_panel(neurons, n_inputs, density=density, seed=0)
    y = torch.from_numpy(np.ascontiguousarray(panel[:, :plan.width])).to(dev)
    got, want = plan.forward(y), plan._eager(y)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "a sharded replay gives the eager forward's bits")
    served = got[:, :ref_cols].clone()
    layer = sharded_layer_times(plan, y)
    layer_checks = sharded_layer_checks(plan, [relaid[id(w)] for w in weights], y)
    del relaid, got, want

    # the unsharded engine on the same inputs
    single = SparseDNNEngine(weights, biases, batch_align=32)
    base = run_challenge(spec, n_inputs=n_inputs, density=density, engine=single)
    check(np.array_equal(res.categories, base.categories),
          ("sharded vs unsharded categories", len(res.categories), len(base.categories)))
    del single
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref_y, ref_cats = oracle_forward(spec, np.ascontiguousarray(panel[:, :ref_cols]), chunk=8)
    oracle_seconds = time.perf_counter() - t0
    got_cats = res.categories[res.categories < ref_cols]
    check(0 < len(ref_cats) < ref_cols, ("nondegenerate answer set", len(ref_cats)))
    check(np.array_equal(got_cats, ref_cats), (got_cats, ref_cats))
    # the served values on the oracle's columns, by the stack criterion:
    # both are f32 evaluations, each within e of the exact forward
    check(bool(torch.isfinite(served).all()) and np.isfinite(ref_y).all(), "finite values")
    oracle = torch.from_numpy(ref_y).to(dev)
    exact, e = f32_chain_bound(weights, biases, y[:, :ref_cols])
    diff = (served.double() - oracle.double()).abs()
    values = {"max_abs_err": float(diff.max()), "max_oracle": float(oracle.abs().max()),
              "bound_share": float((diff / (2 * e + STACK_ATOL)).max()),
              "col_rel_err": col_rel(served.double(), oracle.double()),
              "col_rel_err_vs_exact": {"sharded": col_rel(served.double(), exact),
                                       "oracle": col_rel(oracle.double(), exact)}}
    check(values["max_abs_err"] <= STACK_RTOL * values["max_oracle"], ("values", values))
    check(values["bound_share"] <= 1.0, ("values", values))
    del oracle, exact, e, diff, served

    # the reference's degrade arm: a shard lost at dispatch 1
    inj = FaultInjector()
    inj.schedule(SITE_SHARD_FAILURE, 1, reason="injected shard loss")
    faulted = SparseDNNEngine(weights, biases, batch_align=32, mesh=mesh, fault_injector=inj)
    deg = run_challenge(spec, n_inputs=n_inputs, density=density, engine=faulted)
    check(deg.levels == ("layered",) and deg.routes == ("layered",), (deg.levels, deg.routes))
    check(np.array_equal(deg.categories, res.categories), "categories after the demotion")
    check([(e.level, e.healthy, e.step) for e in faulted.ladder.events]
          == [("sharded", False, 1)], faulted.ladder.describe())
    return {
        "spec": [neurons, layers], "shards": shards, "n_inputs": n_inputs, "density": density,
        "routes": list(res.routes), "levels": list(res.levels), "steps": res.steps,
        "width_classes": list(res.width_classes), "launches": counts, **captured,
        "nnz_per_shard": list(plan.nnz_per_shard()), "imbalance": plan.imbalance(),
        "grid_steps_per_shard": list(plan.grid_steps_per_shard),
        "unsharded_bill": unsharded_bill, "shard_pad_blocks": plan.shard_pad_blocks(),
        "seconds": res.seconds, "edge_inputs_per_sec": res.edge_inputs_per_sec,
        "unsharded": {"route": base.routes[0], "seconds": base.seconds,
                      "edge_inputs_per_sec": base.edge_inputs_per_sec},
        "layer": layer, "layer_checks": layer_checks, "values_vs_oracle": values,
        "peak_memory_gb": peak_gb, "weights_seconds": weights_seconds,
        "categories": int(len(res.categories)), "reference_columns": ref_cols,
        "reference_categories": int(len(ref_cats)), "oracle_seconds": oracle_seconds,
        "degrade": {"levels": list(deg.levels), "routes": list(deg.routes),
                    "events": faulted.ladder.describe()["events"],
                    "categories_match": True},
    }


def sharded_relu_masks(plan, y0) -> list:
    """Each layer's ReLU mask in a sharded plan's forward on the kernels."""
    import torch

    masks, y = [], y0
    with torch.no_grad():
        for i in range(plan.n_layers):
            y = plan.layer_forward(i, y)
            masks.append(y > 0)
    return masks


def phase_sharded_train(neurons, layers, columns, steps, lr, shards) -> dict:
    """train-radixnet's network, every layer block-CSR, through a
    differentiable sharded plan: the first step's gradients against the
    plain versions on the sharded kernels' ReLU masks, the same bits on
    two backward passes, then ``steps`` SGD steps against the unsharded
    differentiable plan's losses, launches per step, step times."""
    import torch

    from repro_torch.core import dnn
    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_row_blocks_mesh
    from repro_torch.plan import build_plan, build_sharded_plan
    from repro_torch.sparse import BlockCSRMatrix
    from repro_torch.train import init_sparse_mlp_state, make_sparse_train_step, sgd

    dev = torch.device("cuda")
    spec = rx.RadixNetSpec(neurons, layers)
    phases, _ = rx.radixnet_weights(spec, device=dev)
    csr, weights = {}, []
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    for w in phases:
        weights.append(he_values(csr.setdefault(id(w), BlockCSRMatrix.from_bsr(w)), gen,
                                 fan_in=32))
    biases = [torch.zeros(neurons, device=dev) for _ in weights]
    y0 = torch.from_numpy(rx.radixnet_input_panel(neurons, columns, density=0.3, seed=0)).to(dev)
    targets = torch.rand((neurons, columns), generator=gen, device=dev)
    t0 = time.perf_counter()
    plan = build_sharded_plan(weights, biases, columns, make_row_blocks_mesh(shards),
                              differentiable=True)
    plan_seconds = time.perf_counter() - t0
    check(plan.imbalance() <= 1.10, plan.imbalance())

    loss1, (dw1, db1) = dnn.dnn_value_and_grad(weights, biases, y0, targets, plan=plan)
    loss2, (dw2, db2) = dnn.dnn_value_and_grad(weights, biases, y0, targets, plan=plan)
    got = [dnn.values_of(g) for g in dw1] + list(db1)
    same_bits = bool(torch.equal(loss1, loss2)) and all(
        torch.equal(a, b) for a, b in zip(got, [dnn.values_of(g) for g in dw2] + list(db2)))
    check(same_bits, "two sharded backward passes give the same bits")
    masks = sharded_relu_masks(plan, y0)
    loss_m, want = grads_on_masks(weights, biases, y0, targets, masks)
    del masks, dw2, db2
    grad_err = max(rel_norm_err(a, b) for a, b in zip(got, want))
    loss_err = abs(float(loss1) - float(loss_m)) / abs(float(loss_m))
    check(all(bool(torch.isfinite(a).all()) for a in got), "finite gradients")
    check(grad_err <= GRAD_RTOL, ("gradients vs plain on the kernels' masks", grad_err))
    check(loss_err <= GRAD_RTOL, ("loss vs plain", loss_err))
    del got, want, dw1, db1

    def train(p):
        state = init_sparse_mlp_state(weights, biases, sgd(lr))
        step = make_sparse_train_step(sgd(lr), plan=p)
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = step(state, {"y0": y0, "targets": targets})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        return losses, times

    ops.reset_launch_counts()
    losses, times = train(plan)
    counts = ops.launch_counts()
    # forward: a launch per shard per layer; backward: dX on each shard's
    # transpose for every layer but the first (its input is data)
    per_step = shards * layers + shards * (layers - 1)
    check(counts == {**dict.fromkeys(ops.KERNELS, 0), "bcsr_spmm": steps * per_step},
          ("launches", counts))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], ("loss falls", losses))
    unsharded, u_times = train(build_plan(weights, biases, columns, differentiable=True))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, unsharded))
    check(loss_rel <= 1e-5, ("sharded vs unsharded losses", losses, unsharded))
    return {
        "spec": [neurons, layers], "shards": shards, "columns": columns,
        "optimizer": f"sgd(lr={lr}, momentum=0.9)", "plan_seconds": plan_seconds,
        "nnz_per_shard": list(plan.nnz_per_shard()), "imbalance": plan.imbalance(),
        "losses": losses, "unsharded_losses": unsharded, "loss_rel_err": loss_rel,
        "first_step_loss_rel_err": loss_err, "grad_rel_err": grad_err,
        "grad_check": f"per layer tensor ||kernel - plain|| <= {GRAD_RTOL} ||plain||, the "
                      "sharded kernels' ReLU masks",
        "same_bits_on_two_backward_passes": same_bits,
        "launches": counts, "launches_per_step": {"forward": shards * layers,
                                                  "backward": shards * (layers - 1)},
        "step_ms": 1e3 * statistics.median(times[1:]), "step_ms_all": [1e3 * t for t in times],
        "unsharded_step_ms": 1e3 * statistics.median(u_times[1:]),
    }


def phase_fleet(neurons, layers, replicas, profile, rate_factor, duration, width_mix,
                width_classes, deadline_s, max_pending_cols, seed, loss_at) -> dict:
    """The reference's fleet arm on the card: ``replicas`` engines of
    RadiX-net ``neurons × layers`` behind ``FleetFrontend`` on a
    ``VirtualClock``, the service model priced by a replayed plan's
    measured time over its bill; every served job's categories against
    the numpy oracle, the plan hit rate, then the same trace with a
    replica lost mid-trace, which must drop no admitted job."""
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.serve import (
        FleetFrontend,
        LoadProfile,
        ReplicaFleet,
        ServiceModel,
        SparseDNNEngine,
        VirtualClock,
        generate_jobs,
    )
    from repro_torch.testing import SITE_REPLICA_LOSS, FaultInjector

    dev = torch.device("cuda")
    spec = rx.RadixNetSpec(neurons, layers)
    weights, biases = rx.radixnet_weights(spec, device=dev)
    jobs = generate_jobs(LoadProfile.bursty(**profile).scaled(rate_factor), duration,
                         m=neurons, seed=seed, width_mix=width_mix, deadline_s=deadline_s)
    # the card's price of a billed block product: a replayed plan of the
    # largest class, its CUDA-event time over its bill
    probe = SparseDNNEngine(weights, biases, batch_align=8)
    top = max(width_classes)
    probe.infer(torch.zeros((neurons, top), device=dev))
    (plan,) = probe.plan_cache.plans()
    y = torch.rand((neurons, top), device=dev)
    replay_ms = gpu_time_ms(lambda: plan.forward(y), per_rep=4, reps=3)
    service = ServiceModel(base_s=2e-3, per_grid_step_s=1e-3 * replay_ms / plan.grid_steps)
    del probe, plan

    def run(injector):
        engines = [SparseDNNEngine(weights, biases, batch_align=8) for _ in range(replicas)]
        fleet = ReplicaFleet(engines, width_classes=width_classes)
        fe = FleetFrontend(fleet, clock=VirtualClock(), service_model=service,
                           max_pending_cols=max_pending_cols, fault_injector=injector)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        stats = fe.run(jobs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = dict.fromkeys(ops.KERNELS, 0)
        for r in fleet.replicas:
            for name, k in plan_launches(r.engine.plan_cache).items():
                want[name] += k
        check(counts == want, ("launches = warm-ups + replays", counts, want))
        check(counts["fused_mlp_forward"] == sum(r.dispatches for r in fleet.replicas), counts)
        return fleet, fe, stats, counts, seconds

    _, fe, stats, counts, seconds = run(None)
    f = stats["fleet"]
    check(stats["failed_jobs"] == 0 and stats["served_jobs"] == stats["admitted_jobs"], stats)
    check(f["plan_hit_rate"] >= 0.9, ("plan hit rate", f["plan_hit_rate"]))
    inj = FaultInjector()
    inj.schedule(SITE_REPLICA_LOSS, loss_at, replica=0)
    _, lfe, lstats, lcounts, lseconds = run(inj)
    check(inj.pending() == 0 and lstats["fleet"]["alive"] == replicas - 1, lstats["fleet"])
    check(lstats["failed_jobs"] == 0 and lstats["served_jobs"] == lstats["admitted_jobs"]
          and lstats["requeued_jobs"] >= 1, lstats)

    # every served job of both runs against the numpy oracle
    rids = sorted(set(fe.results) | set(lfe.results))
    cols = np.cumsum([0] + [jobs[r].cols for r in rids])
    t0 = time.perf_counter()
    ref = np.zeros(cols[-1], bool)
    ref[oracle_categories(spec, np.ascontiguousarray(np.concatenate(
        [jobs[r].features.cpu().numpy() for r in rids], axis=1)))] = True
    oracle_seconds = time.perf_counter() - t0
    for results in (fe.results, lfe.results):
        for i, r in enumerate(rids):
            if r in results:
                got = (results[r] > 0).any(dim=0).cpu().numpy()
                check(np.array_equal(got, ref[cols[i]:cols[i + 1]]), ("job categories", r))
    # the trace's features are U[0, 1): every column stays alive, so the
    # values of the first jobs are held too
    first = [r for r in rids if r in fe.results][:8]
    ref_y, _ = rx.radixnet_reference(spec, np.ascontiguousarray(np.concatenate(
        [jobs[r].features.cpu().numpy() for r in first], axis=1)))
    got_y = torch.cat([fe.results[r] for r in first], dim=1).cpu().double()
    value_err = col_rel(got_y, torch.from_numpy(ref_y).double())
    check(value_err <= STACK_RTOL, ("fleet values vs the oracle", value_err))
    keep = ("offered_jobs", "admitted_jobs", "rejected_jobs", "served_jobs", "failed_jobs",
            "deadline_misses", "miss_rate", "requeued_jobs", "latency_p50_s", "latency_p99_s",
            "latency_max_s", "throughput_cols_per_s", "goodput_cols_per_s")
    return {
        "spec": [neurons, layers], "replicas": replicas,
        "trace": {"profile": {"kind": "bursty", **profile}, "rate_factor": rate_factor,
                  "duration_s": duration, "width_mix": [list(w) for w in width_mix],
                  "width_classes": list(width_classes), "deadline_s": deadline_s,
                  "max_pending_cols": max_pending_cols, "seed": seed, "jobs": len(jobs)},
        "service_model": {"base_s": service.base_s, "per_grid_step_s": service.per_grid_step_s,
                          "replay_ms": replay_ms, "replay_width": top},
        **{k: stats[k] for k in keep},
        "routing": f["routing"], "plan_hit_rate": f["plan_hit_rate"],
        "cross_replica_compiles": f["cross_replica_compiles"],
        "launches": counts, "host_seconds": seconds,
        "oracle_columns": int(cols[-1]), "oracle_categories": int(ref.sum()),
        "oracle_seconds": oracle_seconds, "value_col_rel_err_first_8_jobs": value_err,
        "replica_loss": {"at_dispatch": loss_at, **{k: lstats[k] for k in keep},
                         "routing": lstats["fleet"]["routing"],
                         "events": lstats["fleet"]["events"], "launches": lcounts,
                         "host_seconds": lseconds},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.data import radixnet as rx
    from repro_torch.data.radixnet import RadixNetSpec

    dev = phase_device()
    kern = phase_kernels()

    spec = RadixNetSpec(1024, 120)
    serve, _, serve_res = phase_serve(spec, n_inputs=60000, use_resident=None, density=0.3,
                                      ref_cols=512, route="fused", level="resident",
                                      kernels=("fused_mlp_forward",))
    # the warm-up panel builds and captures the one plan, every timed step
    # replays it: launches = warm-up + replays = steps + 1, and nothing else
    (plan,) = serve["plans"]
    check(plan["warmups"] == 1 and plan["replays"] == serve["steps"]
          and serve["launches"]["fused_mlp_forward"] == serve["steps"] + 1, serve)
    emit({"phase": "serve", **serve})

    layered, layered_engine, _ = phase_serve(spec, n_inputs=2048, use_resident=False,
                                             density=0.3, ref_cols=512, route="layered",
                                             level="layered", kernels=("bsr_spmm", "bcsr_spmm"))
    (layered_plan,) = layered_engine.plan_cache.plans()
    panel, ref_cats = radix_inputs(spec, 2048, 0.3)
    layered["host_share"] = host_share(layered_plan, torch.from_numpy(
        np.ascontiguousarray(panel[:, :layered_plan.width])).to("cuda"))
    emit({"phase": "layered", **layered})

    tiled, _, _ = phase_serve(RadixNetSpec(16384, 120), n_inputs=1024, use_resident=None,
                              density=0.4, ref_cols=64, route="fused-tiled", level="resident",
                              kernels=("fused_mlp_tiled_forward",))
    emit({"phase": "tiled", **tiled})

    dense = phase_dense(spec, panel, ref_cats)
    emit({"phase": "dense", **dense})
    graph = phase_graphblas(spec, panel, ref_cats, layered_plan)
    emit({"phase": "graphblas", **graph})
    train_radix = phase_train_radixnet(**RADIX_TRAIN)
    emit({"phase": "train-radixnet", **train_radix})
    train_paper = phase_train_paper(**PAPER_TRAIN)
    emit({"phase": "train-paper", **train_paper})

    n = CONTINUOUS["n_requests"]
    cont_panel = np.ascontiguousarray(rx.radixnet_input_panel(spec.neurons, n, density=0.3,
                                                              seed=CONTINUOUS["seed"]))
    t0 = time.perf_counter()
    cont_cats = oracle_categories(spec, cont_panel)
    oracle_seconds = time.perf_counter() - t0
    cont = phase_continuous(spec, cont_panel, cont_cats, **CONTINUOUS)
    emit({"phase": "continuous", "oracle_seconds": oracle_seconds, **cont})
    faulted = phase_continuous_faults(spec, cont_panel, cont_cats, **CONTINUOUS)
    emit({"phase": "continuous-faults", **faulted})
    bf16 = phase_serve_bf16(spec, serve_res)
    emit({"phase": "serve-bf16", **bf16})
    tune, table = phase_tune(TUNE_SKEWED, TUNE_RADIX)
    emit({"phase": "tune", **tune})
    served = phase_serve_tuned(TUNE_RADIX["sizes"], TUNE_RADIX["layers"], table,
                               n_inputs=60000, ref_cols=512)
    emit({"phase": "serve-tuned", **served})
    resilient = phase_train_resilient(**RESILIENT)
    emit({"phase": "train-resilient", **resilient})
    sharded = phase_sharded(**SHARDED)
    emit({"phase": "sharded", **sharded})
    sharded_train = phase_sharded_train(**SHARDED_TRAIN)
    emit({"phase": "sharded-train", **sharded_train})
    fleet = phase_fleet(**FLEET)
    emit({"phase": "fleet", **fleet})

    by_phase = {"serve": serve["launches"], "layered": layered["launches"],
                "tiled": tiled["launches"], "dense": dense["launches"],
                "graphblas": graph["launches"],
                "three_call": graph["three_call"]["launches"],
                "train-radixnet": train_radix["launches"],
                "train-paper": train_paper["launches"],
                "continuous": cont["launches"], "continuous-faults": faulted["launches"],
                "serve-bf16": bf16["launches"], "tune": tune["launches"],
                "serve-tuned": served["launches"], "train-resilient": resilient["launches"],
                "sharded": sharded["launches"], "sharded-train": sharded_train["launches"],
                "fleet": fleet["launches"]}
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
