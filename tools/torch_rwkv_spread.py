#!/usr/bin/env python3
"""RWKV-6's first-step gradients under other row groupings and meshes.

    python3 tools/torch_rwkv_spread.py          # on a CUDA host: published width
    python3 tools/torch_rwkv_spread.py --cpu    # the scaled-down config on the CPU

One SGD step (f32 compute) of ``rwkv6-3b`` from one set of seeded weights
and one ``SyntheticLM`` batch (8 rows of 128 tokens, 2 microbatches) on
one position (1 × 1), on the data mesh 2 × 1 (the same rows a group, no
model split) and on the 2 × 2 ``data`` × ``model`` mesh, every position on
one device. Prints one JSON line per depth (1 and 8 layers): for each
pair of meshes, the worst leaf's max |g_a - g_b| over max |g_b| of the
gradients, at f32 compute and at f64 (params, compute and the model's
f32 casts in f64; the gradients still accumulate in f32), and each
mesh's gradient norm at bf16 compute.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from chip_smoke import f64_casts  # noqa: E402

MESHES = (("1x1", 1, 1), ("2x1", 2, 1), ("2x2", 2, 2))


def step(cfg, params, batch, data: int, model: int, device):
    """(gradients gathered on the host, grad norm) of one SGD step."""
    from repro_torch.distribution.sharding import Placed, param_pspecs, place, shardings_for
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import Model
    from repro_torch.train import checkpoint, make_train_step, sgd
    from repro_torch.train.optimizer import Optimizer, init_placed
    from repro_torch.train.trainer import TrainState

    mesh = make_local_mesh(data, model=model, device=device)
    opt = sgd(1e-2, momentum=0.0)
    seen = []

    def update(grads, state, leaves, *, gnorm=None):
        seen.append(grads)
        return opt.update(grads, state, leaves, gnorm=gnorm)

    placed = place(params, shardings_for(None, mesh, param_pspecs(None, params, mesh)))
    owners = checkpoint.leaves(placed)
    _, metrics = make_train_step(Model(cfg), Optimizer(opt.init, update), microbatches=2)(
        TrainState(placed, init_placed(opt, owners)), batch)
    grads = [None if g is None else Placed(tuple(per[j] for per in seen), x.sharding).gather("cpu")
             for j, (g, x) in enumerate(zip(seen[0], owners))]
    return grads, float(metrics["grad_norm"])


def spread(g: dict, a: str, b: str) -> float:
    return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(g[a], g[b]) if y is not None and y.numel())


def main(argv=None) -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model

    cpu = "--cpu" in (sys.argv[1:] if argv is None else argv)
    device = "cpu" if cpu else "cuda"
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu for the scaled-down config")
    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_config("rwkv6-3b")
    if cpu:
        base = base.scaled_down(max_seq_len=128)
    else:
        print(torch.cuda.get_device_name(0), flush=True)
    for layers in (1, 8):
        cfg = dataclasses.replace(base, num_layers=layers)
        params = Model(cfg).init(torch.Generator(device=device).manual_seed(0), device=device)
        batch = {k: torch.from_numpy(v) for k, v in
                 SyntheticLM(cfg.vocab_size, 128, 8, seed=0).batch(0).items()}
        rec = {"layers": layers, "device": device, "params": sum(
            x.numel() for x in torch.utils._pytree.tree_leaves(params))}
        for dtype in ("float32", "float64"):
            c = dataclasses.replace(cfg, compute_dtype=dtype, param_dtype=dtype)
            p = params if dtype == "float32" else torch.utils._pytree.tree_map(
                lambda x: x.double() if x.is_floating_point() else x, params)
            g = {}
            with f64_casts() if dtype == "float64" else contextlib.nullcontext():
                for name, d, m in MESHES:
                    g[name] = step(c, p, batch, d, m, device)[0]
                    if not cpu:
                        torch.cuda.empty_cache()
            rec[dtype] = {f"{a}_vs_{b}": spread(g, a, b)
                          for a, b in (("2x2", "1x1"), ("2x1", "1x1"), ("2x2", "2x1"))}
            del g, p
        rec["grad_norm_bf16"] = {name: step(cfg, params, batch, d, m, device)[1]
                                 for name, d, m in MESHES}
        print(json.dumps(rec), flush=True)
        del params
        if not cpu:
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
