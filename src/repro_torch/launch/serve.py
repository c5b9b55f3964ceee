"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``

Counterpart of ``repro/launch/serve.py`` with its flags, plus
``--device`` (default: the card; without one the launcher raises rather
than fall back to the CPU). Builds the model, draws its weights from
``--seed`` on the device, and drives the LLM ``Engine`` (prefill + decode
loop with sampling) over seeded prompts.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.layers import tree_leaves
from repro_torch.models.model import Model
from repro_torch.serve.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--scale-down", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.scale_down:
        cfg = cfg.scaled_down(max_seq_len=args.cache_len)
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed), device=device)
    n_params = sum(leaf.numel() for leaf in tree_leaves(params))
    print(f"[serve] arch={cfg.name} params={n_params/1e6:.1f}M device={device}")

    engine = Engine(model, params, batch_size=args.batch, cache_len=args.cache_len,
                    temperature=args.temperature, seed=args.seed, device=device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=device).manual_seed(args.seed + 1),
                            device=device, dtype=torch.int32)

    t0 = time.monotonic()
    tokens, stats = engine.generate(prompts, args.max_new_tokens)
    synchronize(device)
    dt = time.monotonic() - t0
    print(
        f"[serve] generated {stats['generated_tokens']} tokens in {dt:.2f}s"
        f" ({stats['generated_tokens']/dt:,.1f} tok/s)"
        f" cache={stats['cache_bytes']/2**20:.1f}MiB"
    )
    print("[serve] sample output ids:", tokens[0, :16].tolist())


if __name__ == "__main__":
    main()
