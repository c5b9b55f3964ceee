"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Counterpart of ``repro/launch/train.py`` with its flags, plus
``--device`` and ``--data``. The reference's driver loop: parameters
and AdamW state (f32 moments, a warmup-cosine schedule) drawn from
``--seed``, placed on the model's local mesh by ``param_pspecs`` (the
reference's ``device_put``), the microbatched train step, ``SyntheticLM``
batches through a ``Prefetcher`` (each position's rows copied to its
device), and the checkpoint-and-restart ``Supervisor`` run in chunks of
10 steps, a checkpoint at each chunk's end; ``--resume`` restarts from
the newest checkpoint in ``--ckpt-dir``, restored onto the mesh.

The mesh is ``make_local_mesh(model=1)``: without ``--device``, every
visible card a position of the ``data`` axis, as the reference's mesh
takes every device (without a card the launcher raises rather than fall
back to the CPU; ``--data N`` takes the first N cards); with
``--device``, ``--data`` positions (default 1) all on that device, the
port's counterpart of the reference's forced host devices.
``--production-mesh`` takes the reference's 16 × 16 mesh, one card a
position, and is refused on a host without its 256 cards. The model is
trained dense, as in the reference
(``Model.sparsify`` is not called).

``main(argv)`` returns each step's metrics as floats,
``[{"step": s, "loss": ..., "grad_norm": ..., "ce": ..., "moe_aux": ...}]``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.distribution.sharding import ShardingRules
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.model import Model
from repro_torch.train import adamw, checkpoint
from repro_torch.train.fault_tolerance import StragglerPolicy, Supervisor
from repro_torch.train.optimizer import warmup_cosine
from repro_torch.train.trainer import (
    TrainState,
    init_train_state,
    make_train_step,
    state_shardings,
)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--scale-down", action="store_true", help="reduced config")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="one torch device for every position (default: every card)")
    ap.add_argument("--data", type=int, default=None,
                    help="positions of the data axis: on --device (default 1), or cards")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.scale_down:
        cfg = cfg.scaled_down(max_seq_len=args.seq_len)
    model = Model(cfg)
    opt = adamw(warmup_cosine(args.lr, 10, args.steps), state_dtype=torch.float32)
    mesh = (make_production_mesh() if args.production_mesh
            else make_local_mesh(args.data, model=1, device=args.device))
    rules = ShardingRules()
    print(f"[train] arch={cfg.name} mesh={dict(mesh.shape)} params=", end="")

    state = init_train_state(model, opt,
                             torch.Generator(device=mesh.device).manual_seed(args.seed),
                             mesh=mesh, rules=rules)
    n_params = sum(leaf.numel() for leaf in checkpoint.leaves(state.params))
    print(f"{n_params/1e6:.1f}M")
    shardings = state_shardings(cfg, state, mesh, rules)
    step_fn = make_train_step(model, opt, microbatches=args.microbatches)

    start_step = 0
    if args.resume and checkpoint.latest_step(args.ckpt_dir) is not None:
        state, manifest = checkpoint.restore(args.ckpt_dir, state, shardings=shardings)
        start_step = manifest["step"]
        print(f"[train] resumed from step {start_step}")

    data = SyntheticLM(cfg.vocab_size, args.seq_len, args.global_batch, seed=args.seed,
                       input_mode=cfg.input_mode, d_model=cfg.d_model)
    prefetch = Prefetcher(data, start_step=start_step)
    metrics_box: dict = {}
    history: list[dict] = []

    def step(state, i):
        _, host_batch = prefetch.next()
        batch = {k: torch.from_numpy(v) for k, v in host_batch.items()}
        state, metrics = step_fn(state, batch)
        metrics_box.update({k: float(v) for k, v in metrics.items()})
        history.append({"step": i + 1, **metrics_box})
        return state

    sup = Supervisor(
        step_fn=step,
        save_state=lambda s: s,
        load_state=lambda t: TrainState(*t),
        ckpt_dir=args.ckpt_dir,
        ckpt_interval=args.ckpt_interval,
        straggler=StragglerPolicy(),
        metadata={"arch": cfg.name},
    )
    try:
        t0 = time.monotonic()
        last_log = start_step
        # run in chunks so we can log without complicating the supervisor
        s = start_step
        while s < args.steps:
            chunk_end = min(s + 10, args.steps)
            state = sup.run(state, chunk_end, start_step=s)
            dt = time.monotonic() - t0
            tok_s = (chunk_end - last_log) * args.global_batch * args.seq_len / dt
            print(
                f"[train] step {chunk_end:5d} loss={metrics_box.get('loss', 0):.4f}"
                f" grad_norm={metrics_box.get('grad_norm', 0):.3f}"
                f" tok/s={tok_s:,.0f}"
            )
            t0, last_log = time.monotonic(), chunk_end
            s = chunk_end
    finally:
        prefetch.close()
    print("[train] done")
    return history


if __name__ == "__main__":
    main()
