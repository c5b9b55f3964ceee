#!/usr/bin/env python3
"""Time one tree's sparse training step on train-radixnet's network, on one
GPU, so two trees can be compared in one call.

    python3 tools/torch_train_compare.py [SRC]   # from the repository root, on a CUDA host

SRC is the ``src`` directory whose ``repro_torch`` is timed (default: this
checkout's); run it for a parent tree and for a change in turns (parent,
change, change, parent) inside one chip call. The network is
``chip_smoke.py``'s ``RADIX_TRAIN``: RadiX-net 1024 × 120's stored blocks
(the stride-1 phase as block-CSR) with seeded He-scale values, zero
biases, a 512-column Philox panel, SGD through a differentiable plan.
After two warm-up steps it prints, as one JSON line, the median host
milliseconds (each ended by ``torch.cuda.synchronize()``) of ``REPS``
forwards, forward-and-backward passes and train steps, the launches of
one step, and whether two identical backward passes gave the same bits;
then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]

import chip_smoke as smoke  # noqa: E402  (the network and seeds of the smoke run)

REPS = 10


def main() -> int:
    src = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else os.path.join(ROOT, "src")
    sys.path.insert(0, src)  # ahead of the checkout's src, which chip_smoke added
    import torch

    if not torch.cuda.is_available():
        print("torch_train_compare.py: no CUDA device available", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.core import dnn
    from repro_torch.data import radixnet as rx
    from repro_torch.kernels import ops
    from repro_torch.plan import build_plan
    from repro_torch.plan.layout import to_preferred_layout
    from repro_torch.train import init_sparse_mlp_state, make_sparse_train_step, sgd

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke.RADIX_TRAIN
    dev = torch.device("cuda")
    neurons, columns = cfg["neurons"], cfg["columns"]
    phases, _ = rx.radixnet_weights(rx.RadixNetSpec(neurons, cfg["layers"]), device=dev)
    relaid, weights = {}, []
    gen = torch.Generator(device=dev).manual_seed(smoke.TRAIN_SEED)
    for w in phases:
        if id(w) not in relaid:
            relaid[id(w)] = to_preferred_layout(w)
        weights.append(smoke.he_values(relaid[id(w)], gen, fan_in=32))
    biases = [torch.zeros(neurons, device=dev) for _ in weights]
    y0 = torch.from_numpy(rx.radixnet_input_panel(neurons, columns, density=0.3,
                                                  seed=0)).to(dev)
    targets = torch.rand((neurons, columns), generator=gen, device=dev)
    plan = build_plan(weights, biases, columns, differentiable=True)

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    def forward():
        with torch.no_grad():
            out = dnn.dnn_forward_trainable(weights, biases, y0, plan=plan)
        return 0.5 * torch.mean((out - targets) ** 2)

    def grads():
        return dnn.dnn_value_and_grad(weights, biases, y0, targets, plan=plan)

    opt = sgd(cfg["lr"])
    step = make_sparse_train_step(opt, plan=plan)
    batch = {"y0": y0, "targets": targets}
    state = init_sparse_mlp_state(weights, biases, opt)
    for _ in range(2):  # warm-up: kernel builds, piece tables
        state, _ = step(state, batch)
        grads()
    ops.reset_launch_counts()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    times = {"forward": [], "forward_backward": [], "step": []}
    for _ in range(REPS):
        times["forward"].append(timed(forward))
        times["forward_backward"].append(timed(grads))
        times["step"].append(timed(lambda: step(state, batch)))
    (_, (dw1, db1)), (_, (dw2, db2)) = grads(), grads()
    same = all(torch.equal(dnn.values_of(a), dnn.values_of(b)) for a, b in zip(dw1, dw2)) and all(
        torch.equal(a, b) for a, b in zip(db1, db2))
    print(json.dumps({
        "src": os.path.dirname(repro_torch.__file__),
        **{f"{k}_ms": statistics.median(v) for k, v in times.items()},
        "backward_ms": statistics.median(times["forward_backward"])
        - statistics.median(times["forward"]),
        **{f"{k}_ms_all": v for k, v in times.items()},
        "launches_per_step": launches, "backward_bit_identical": same,
    }), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
