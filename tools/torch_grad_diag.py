#!/usr/bin/env python3
"""Per-layer gradient errors of the train-radixnet cell against an f64 pass.

    python3 tools/torch_grad_diag.py [LAYERS ...]   # from the repository root, on a CUDA host

For each depth (default 8, 30 and 120 layers of RadiX-net 1024's topology
with ``chip_smoke.py``'s seeded He-scale values, a 512-column Philox panel
and uniform targets) it computes the first step's gradients three ways:
through the kernels (a differentiable plan), through the plain versions in
f32, and through the plain versions in f64. It prints one JSON line per
depth with the worst layer's ``||a - b|| / ||b||`` for each pair, then a
line per sampled layer. An error that starts at one layer and covers every
layer upstream of it is a ReLU mask entry that one f32 order rounded to
the other side of 0; an error of one path in every layer would be a fault.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as smoke  # noqa: E402  (the cell's values and seed)


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_grad_diag.py: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core import dnn
    from repro_torch.data import radixnet as rx
    from repro_torch.plan import build_plan
    from repro_torch.plan.layout import to_preferred_layout

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for layers in [int(a) for a in sys.argv[1:]] or [8, 30, 120]:
        phases, _ = rx.radixnet_weights(rx.RadixNetSpec(1024, layers), device=dev)
        relaid, ws = {}, []
        gen = torch.Generator(device=dev).manual_seed(smoke.TRAIN_SEED)
        for w in phases:
            if id(w) not in relaid:
                relaid[id(w)] = to_preferred_layout(w)
            ws.append(smoke.he_values(relaid[id(w)], gen, 32))
        bs = [torch.zeros(1024, device=dev) for _ in ws]
        y0 = torch.from_numpy(rx.radixnet_input_panel(1024, 512, density=0.3, seed=0)).to(dev)
        tg = torch.rand((1024, 512), generator=gen, device=dev)
        plan = build_plan(ws, bs, 512, differentiable=True)
        lk, (gk, bk) = dnn.dnn_value_and_grad(ws, bs, y0, tg, plan=plan)
        lp, (gp, bp) = dnn.dnn_value_and_grad(ws, bs, y0, tg, use_kernel=False)
        ws64 = [dnn.with_values(w, dnn.values_of(w).double()) for w in ws]
        l64, (g64, b64) = dnn.dnn_value_and_grad(ws64, [b.double() for b in bs], y0.double(),
                                                 tg.double(), use_kernel=False)
        rows = []
        for i in range(layers):
            vk, vp, v64 = (dnn.values_of(g[i]) for g in (gk, gp, g64))
            rows.append({"layer": i, "layout": type(ws[i]).__name__,
                         "w_kernel_plain": rel(vk, vp), "w_kernel_f64": rel(vk, v64),
                         "w_plain_f64": rel(vp, v64), "b_kernel_plain": rel(bk[i], bp[i]),
                         "b_kernel_f64": rel(bk[i], b64[i]), "b_plain_f64": rel(bp[i], b64[i])})
        worst = {k: max(r[k] for r in rows) for k in rows[0] if k.startswith(("w_", "b_"))}
        print(json.dumps({"layers": layers, "loss": [float(lk), float(lp), float(l64)],
                          "worst": worst}), flush=True)
        for r in rows[::max(1, layers // 15)] + rows[-1:]:
            print(json.dumps(r), flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
