#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s sharded phases, the one-card ones and the ones
across cards, on a host with several GPUs, then try a CUDA graph capture
of a sharded forward across the cards.

    python3 tools/torch_cards_run.py [PHASE ...]   # from the repository root, on a 4-GPU host

Phases, each one JSON line as in ``chip_smoke.py`` (any failed check
raises, and the exit code is not 0): ``device`` (the kernels' build, and
every card's ``nvidia-smi`` name and power limit), ``copy-modes``
(below), ``sharded`` (RadiX-net
65536 × 120 as 4 shards on card 0, the comparison), ``sharded-cards``
(the same over one card a shard), ``sharded-train`` and
``sharded-cards-train``. Then ``capture-across-cards``: RadiX-net 1024 ×
120 over the cards, its forward recorded with ``torch.cuda.graph`` on
card 0 after an eager warm-up: whether CUDA and PyTorch accept the
capture, and, if they do, whether a replay gives the eager forward's
bits. The other cards' streams are not forked from the capture stream,
so this is the plain capture, not a capture made to span the cards.
That probe is a measurement, not the serving path: a sharded plan on
several cards runs eagerly (``ShardedStackPlan.eager_because``).

The model's data mesh: ``data-cards-bits`` (one train step of
Llama-3.2-1B at published width, dense and with every FFN block-pruned,
2 microbatches of the launcher's batch, on 4 positions of card 0 and on
4 cards: the same loss, metrics and every chunk of the new state bit for
bit, and the sparse model's launches on each card), then
``chip_smoke.py``'s ``llm-train-data`` and ``launch-train-data`` over
the 4 cards. The model axis: ``model-cards-bits`` (the same step on the
2 × 2 ``data`` × ``model`` mesh, on card 0 and on 4 cards, the same bits;
the sparse model's launches on each group's home card),
``mixer-cards-bits`` (the same for DeepSeek-V2's MLA, Jamba's Mamba and
RWKV-6 at published width, cut as ``chip_smoke.MIXER_CUTS``, and Jamba's
layer with its FFN pruned), then ``chip_smoke.py``'s ``llm-train-model``
over the 4 cards. Serving over the model axis: ``serve-cards-bits`` (the
2 × 2 serve of Llama-3.2-1B and of each ``chip_smoke.SERVE_MIXER_CUTS``
cut through ``make_serve_fns``, on 4 positions of card 0 and on 4 cards:
every call's logits, the greedy tokens and every cache chunk bit for
bit), then ``chip_smoke.py``'s ``llm-serve-model`` over the 4 cards.
The dry run against the cards: ``dryrun-cards`` (the ``dryrun`` phase's
2 × 2 mesh cells, Llama-3.2-1B ``train_4k`` cut to 8 layers and
``decode_32k``, traced through the mesh path on ``meta`` and run one
card a position: each card's ``max_memory_allocated`` within 10% of its
position's traced peak, each card's received bytes, the FLOPs and the
exchanges by kind equal to the trace's; with them the ``train_4k_seq``
cell, its sequence split over ``model``). Sequence parallelism across
cards: ``seq-cards-bits`` (the 2 × 2 train step and a prefill with
greedy decode steps of Llama-3.2-1B under ``ShardingRules(seq_axis=
"model")``, on 4 positions of card 0 and on 4 cards, bit for bit). A MoE
whose token groups cross data indices: ``moe-serve-cards-bits``
(``chip_smoke.SERVE_MOE``'s Moonlight cut at f32 served 2 × 2, and one
step of ``chip_smoke.MOE_CROSSING``'s batch, on 4 positions of card 0
and on 4 cards, bit for bit).
``dryrun-mesh`` runs the ``dryrun`` phase's mesh cells on one card on
their own (with ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` in
the environment, as the ``dryrun`` phase runs them: the decode cell
fills the card). Naming phases runs those alone (``device`` and ``cards`` always run
first).

``copy-modes`` times one layer of RadiX-net 65536 × 120 over the cards
(4 shards, 512 columns) and a whole forward with two ways of copying
between cards, in turns (A B B A, four rounds): ``plain``,
``distribution.peer.copy_into`` as it is (PyTorch's cross-device
``copy_`` on the cards' current streams), and ``stream-pairs``
(:func:`stream_pair_copy`: a send and a receive stream for each pair of
cards, each copy fenced on both sides from Python). The host clock runs
around ``reps`` calls with every card synchronised before and after;
the outputs of the two must be the same bits.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as smoke  # noqa: E402  (the phases and their checks)


def capture_across_cards(shards: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.plan import build_sharded_plan

    mesh = smoke.cards_mesh(shards)
    weights, biases = rx.radixnet_weights(rx.RadixNetSpec(1024, 120), device=mesh.device)
    plan = build_sharded_plan(weights, biases, 64, mesh)
    y = torch.from_numpy(np.ascontiguousarray(
        rx.radixnet_input_panel(1024, 64, density=0.3, seed=0))).to(mesh.device)
    eager = plan._eager(y)
    smoke.sync_cards(plan)
    static_in = y.clone()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            static_out = plan._run(static_in)
        graph.replay()
        smoke.sync_cards(plan)
    except Exception as e:  # noqa: BLE001 — the outcome is what this probe reports
        return {"cards": len(plan.cards), "accepted": False,
                "error": f"{type(e).__name__}: {e}"[:1000]}
    return {"cards": len(plan.cards), "accepted": True,
            "replay_bit_identical": bool(torch.equal(static_out, eager))}


_pairs: dict = {}


def stream_pair_copy(dst, src):
    """``dst ← src`` between two cards on the pair's own streams: the send
    stream waits for the source's producer, the receive stream for the
    destination's allocation, the destination's stream for the copy."""
    import torch

    if dst.device == src.device:
        return dst.copy_(src)
    key = (src.device.index, dst.device.index)
    if key not in _pairs:
        _pairs[key] = (torch.cuda.Stream(src.device), torch.cuda.Stream(dst.device))
    send, recv = _pairs[key]
    send.wait_stream(torch.cuda.current_stream(src.device))
    recv.wait_stream(torch.cuda.current_stream(dst.device))
    with torch.cuda.stream(send), torch.cuda.stream(recv):
        dst.copy_(src)
    src.record_stream(send)
    torch.cuda.current_stream(dst.device).wait_stream(recv)
    return dst


def copy_modes(neurons=65536, layers=120, shards=4, width=512, density=0.45,
               rounds=4, reps=10) -> dict:
    import statistics
    import time

    import numpy as np
    import torch

    from repro_torch.data import radixnet as rx
    from repro_torch.distribution import peer
    from repro_torch.plan import build_sharded_plan

    mesh = smoke.cards_mesh(shards)
    weights, biases = rx.radixnet_weights(rx.RadixNetSpec(neurons, layers), device=mesh.device)
    plan = build_sharded_plan(weights, biases, width, mesh)
    y = torch.from_numpy(np.ascontiguousarray(rx.radixnet_input_panel(
        neurons, width, density=density, seed=0))).to(mesh.device)
    i = max(range(plan.n_layers), key=lambda k: sum(plan.layers[k].nnz_per_shard))
    panels = plan.scatter(y)
    modes = {"plain": peer.copy_into, "stream-pairs": stream_pair_copy}

    def host_ms(fn, n) -> float:
        smoke.sync_cards(plan)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        smoke.sync_cards(plan)
        return 1e3 * (time.perf_counter() - t0) / n

    layer_ms = {m: [] for m in modes}
    forward_ms = {m: [] for m in modes}
    outs = {}
    try:
        for m in modes:  # warm-up, and each mode's output
            peer.copy_into = modes[m]
            plan._layer(i, panels, plan.cards)
            outs[m] = plan._run(y).cpu()
        for _ in range(rounds):
            for m in ("plain", "stream-pairs", "stream-pairs", "plain"):
                peer.copy_into = modes[m]
                layer_ms[m].append(host_ms(lambda: plan._layer(i, panels, plan.cards), reps))
                forward_ms[m].append(host_ms(lambda: plan._run(y), 2))
    finally:
        peer.copy_into = modes["plain"]
    smoke.check(torch.equal(outs["plain"], outs["stream-pairs"]),
                "the two copy modes give the same bits")
    return {"spec": [neurons, layers], "cards": len(plan.cards), "width": width, "layer": i,
            "order": "A B B A x %d, A = plain" % rounds,
            "layer_ms": layer_ms, "forward_ms": forward_ms,
            "layer_ms_median": {m: statistics.median(t) for m, t in layer_ms.items()},
            "forward_ms_median": {m: statistics.median(t) for m, t in forward_ms.items()},
            "same_bits": True}


def same_step_on_one_card_and_cards(model, params, batch, one, cards, microbatches: int,
                                    label: str) -> dict:
    """One AdamW step of ``model`` from ``params`` on the mesh ``one`` (every
    position on card 0) and on ``cards`` (one position a card): metrics and
    every chunk of the new state (params and moments) must be the same
    bits. Returns the metrics, the leaves compared, each mesh's launches by
    card, and the cards' step ms (host clock, every card synchronised)."""
    import time

    import torch

    from repro_torch.distribution.sharding import param_pspecs, place, shardings_for
    from repro_torch.kernels import ops
    from repro_torch.train import adamw, checkpoint
    from repro_torch.train.optimizer import init_placed, warmup_cosine
    from repro_torch.train.trainer import TrainState, make_train_step

    opt = adamw(warmup_cosine(3e-4, 10, 100), state_dtype=torch.float32)
    step = make_train_step(model, opt, microbatches=microbatches)
    runs = []
    for mesh in (one, cards):
        placed = place(params, shardings_for(None, mesh, param_pspecs(None, params, mesh)))
        state = TrainState(placed, init_placed(opt, checkpoint.leaves(placed)))
        del placed
        smoke.sync_all()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        smoke.sync_all()
        ms = 1e3 * (time.perf_counter() - t0)
        runs.append(({k: float(v) for k, v in metrics.items()}, state,
                     {str(d): ops.launch_counts(d) for d in mesh.cards}, ms))
    (m1, s1, l1, _), (m4, s4, l4, ms4) = runs
    leaves1, leaves4 = smoke.placed_leaves(s1), smoke.placed_leaves(s4)
    differ = [j for j, (x, y) in enumerate(zip(leaves1, leaves4))
              if not all(torch.equal(a.to(b.device), b) for a, b in zip(x.chunks, y.chunks))]
    same = m1 == m4 and len(leaves1) == len(leaves4) and not differ
    smoke.check(same, (label, "a step on 4 cards is the 4-position one-card step", m1, m4,
                       "leaves that differ", differ))
    return {"metrics": m4, "same_bits": True, "leaves": len(leaves4), "cards_step_ms": ms4,
            "launches_one_card": l1, "launches_by_card": l4}


def data_cards_bits(arch="llama3.2-1b", seq_len=128, global_batch=8, microbatches=2,
                    positions=4, block=128, blocks_per_row=4, seed=0, model_axis=1) -> dict:
    """One train step from the same weights and batch on a mesh of
    ``positions`` positions (``positions / model_axis`` × ``model_axis``)
    on card 0 and on as many cards: metrics and every chunk of the new
    state (params and moments) must be the same bits; the sparse model's
    launches split by card (each group's on its home card)."""
    import dataclasses

    import torch

    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import Model

    data = positions // model_axis
    one = make_local_mesh(data, model=model_axis, device="cuda:0")
    cards = make_local_mesh(data, model=model_axis,
                            devices=[f"cuda:{i}" for i in range(positions)])
    cfg = get_config(arch)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(cfg.vocab_size, seq_len, global_batch, seed=seed).batch(0).items()}
    params = Model(cfg).init(torch.Generator(device="cuda:0").manual_seed(seed), device="cuda:0")
    out = {}
    for name in ("dense", "sparse"):
        model = Model(cfg)
        if name == "sparse":
            model = Model(dataclasses.replace(cfg, sparsity=SparsityConfig(
                (block, block), blocks_per_row=blocks_per_row, targets=("ffn",))))
            params = model.sparsify(params)
        out[name] = same_step_on_one_card_and_cards(model, params, batch, one, cards,
                                                    microbatches, name)
        if name == "sparse":
            l1, l4 = out[name]["launches_one_card"], out[name]["launches_by_card"]
            n = 3 * cfg.num_layers * microbatches
            homes = cards.devices[::model_axis]
            smoke.check(all(c["bsr_spmm"] == c["bcsr_spmm"] == n * homes.count(torch.device(d))
                            for d, c in l4.items())
                        and all(c["bsr_spmm"] == data * n for c in l1.values()),
                        ("sparse launches by card", l1, l4))
    return {"arch": arch, "mesh": dict(cards.shape), "cards": len(cards.cards), **out}


def mixer_cards_bits(seq_len=128, global_batch=8, microbatches=2, block=128, blocks_per_row=4,
                     seed=0) -> dict:
    """The same comparison for ``chip_smoke.MIXER_CUTS`` (MLA, Mamba,
    RWKV-6 at published width, cut in depth) on the 2 × 2 ``data`` ×
    ``model`` mesh, and the pruned mixer's cut with its FFNs block-pruned
    (its SpMM launches on the groups' home cards, 0 and 2, only)."""
    import dataclasses

    import torch

    from repro_torch.configs import SparsityConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import Model

    one = make_local_mesh(2, model=2, device="cuda:0")
    cards = make_local_mesh(2, model=2, devices=[f"cuda:{i}" for i in range(4)])
    out = {}
    for name, cut in smoke.MIXER_CUTS.items():
        cfg = smoke.cut_config(name, **cut)
        batch = {k: torch.from_numpy(v) for k, v in
                 SyntheticLM(cfg.vocab_size, seq_len, global_batch, seed=seed).batch(0).items()}
        params = Model(cfg).init(torch.Generator(device="cuda:0").manual_seed(seed),
                                 device="cuda:0")
        out[name] = same_step_on_one_card_and_cards(Model(cfg), params, batch, one, cards,
                                                    microbatches, name)
        if name == smoke.LLM_TRAIN_MODEL["pruned_mixer"]:
            pcfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
                (block, block), blocks_per_row=blocks_per_row, targets=("ffn",)))
            pruned = same_step_on_one_card_and_cards(Model(pcfg), Model(pcfg).sparsify(params),
                                                     batch, one, cards, microbatches,
                                                     name + " pruned")
            n = 3 * pcfg.num_layers * microbatches
            smoke.check({d: (c["bsr_spmm"], c["bcsr_spmm"]) for d, c in
                         pruned["launches_by_card"].items()}
                        == {f"cuda:{i}": (n, n) if i % 2 == 0 else (0, 0) for i in range(4)},
                        ("pruned launches on the home cards", pruned["launches_by_card"]))
            out[name + "-pruned"] = pruned
        del params
        torch.cuda.empty_cache()
    return {"mesh": dict(cards.shape), "cards": len(cards.cards), "cuts": smoke.MIXER_CUTS,
            "archs": out}


def serve_on(model, params, mesh, prompts, new_tokens: int, cache_len: int) -> tuple:
    """``chip_smoke.serve_greedy`` over ``params`` and a fresh cache placed on
    ``mesh``: (each call's logits, the tokens, the placed cache, each
    card's launches, the median decode step's ms)."""
    import statistics

    import torch

    from repro_torch.kernels import ops

    pp, cache = smoke.placed_for_serving(model, params, mesh, prompts.shape[0], cache_len)
    ops.reset_launch_counts()
    calls, ms, _ = smoke.serve_greedy(model, pp, cache, prompts, new_tokens)
    tokens = torch.stack([smoke.greedy(c) for c in calls], 1)
    return (calls, tokens, cache, {str(d): ops.launch_counts(d) for d in mesh.cards},
            statistics.median(ms[1:]))


def serve_cards_bits(batch=4, cache_len=128, prompt_len=48, new_tokens=40, seed=0) -> dict:
    """The 2 × 2 serve of ``chip_smoke.LLM_SERVE_MODEL``'s Llama-3.2-1B (bf16
    serving copy, 40 greedy tokens across the slot-range boundary) and of
    each ``chip_smoke.SERVE_MIXER_CUTS`` cut at published width (Gemma-3's
    sizes from ``SERVE_LONG``) on 4 positions of card 0 and on 4 cards:
    every call's logits, the tokens and every cache chunk bit for bit; the
    median decode step's ms on each."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import Model
    from repro_torch.models.model import cast_floating
    from repro_torch.train import checkpoint

    one = make_local_mesh(2, model=2, device="cuda:0")
    cards = make_local_mesh(2, model=2, devices=[f"cuda:{i}" for i in range(4)])
    out = {}
    for name, cut in {"llama3.2-1b": None, **smoke.SERVE_MIXER_CUTS}.items():
        cfg = get_config(name) if cut is None else smoke.cut_config(name, **cut)
        sizes = {"cache_len": cache_len, "prompt_len": prompt_len, "new_tokens": new_tokens,
                 **smoke.SERVE_LONG.get(name, {})}
        model = Model(cfg)
        params = cast_floating(model.init(torch.Generator(device="cuda:0").manual_seed(seed),
                                          device="cuda:0"), model.compute_dtype)
        prompts = torch.randint(0, cfg.vocab_size, (batch, sizes["prompt_len"]),
                                device="cuda:0",
                                generator=torch.Generator(device="cuda:0").manual_seed(seed + 1))
        (c1, t1, k1, _, ms1), (c4, t4, k4, l4, ms4) = (
            serve_on(model, params, mesh, prompts, sizes["new_tokens"], sizes["cache_len"])
            for mesh in (one, cards))
        leaves = list(zip(checkpoint.leaves(k1), checkpoint.leaves(k4)))
        same = (torch.equal(t1, t4.to(t1.device))
                and all(torch.equal(a, b.to(a.device)) for a, b in zip(c1, c4))
                and all(torch.equal(a.to(b.device), b) for x, y in leaves
                        for a, b in zip(x.chunks, y.chunks)))
        smoke.check(same, (name, "the 4-card serve is the 4-position one-card serve"))
        out[name] = {"cut": cut, **sizes, "same_bits": True, "cache_leaves": len(leaves),
                     "first_tokens": t4[:, :8].tolist(), "decode_step_ms_one_card": ms1,
                     "decode_step_ms_cards": ms4, "launches_by_card": l4}
        del params, k1, k4, c1, c4
        torch.cuda.empty_cache()
    return {"mesh": dict(cards.shape), "cards": len(cards.cards), "archs": out}


def moe_serve_cards_bits(batch=4, cache_len=128, prompt_len=48, seed=0) -> dict:
    """``chip_smoke.SERVE_MOE``'s Moonlight cut at f32, its MoE token groups
    crossing data indices, on the 2 × 2 mesh on 4 positions of card 0 and on
    4 cards: the serve (``chip_smoke.SERVE_MOE``'s new tokens) through
    ``make_serve_fns``, every call's logits, the tokens and every cache
    chunk bit for bit; then one step of ``chip_smoke.MOE_CROSSING``'s batch
    (its microbatches' groups crossing too), the metrics and every chunk of
    the new state bit for bit."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import Model
    from repro_torch.train import checkpoint

    one = make_local_mesh(2, model=2, device="cuda:0")
    cards = make_local_mesh(2, model=2, devices=[f"cuda:{i}" for i in range(4)])
    cut = smoke.SERVE_MOE
    cfg = dataclasses.replace(get_config(cut["arch"]), num_layers=cut["num_layers"],
                              compute_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda:0").manual_seed(seed), device="cuda:0")
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), device="cuda:0",
                            generator=torch.Generator(device="cuda:0").manual_seed(seed + 1))
    (c1, t1, k1, _, ms1), (c4, t4, k4, l4, ms4) = (
        serve_on(model, params, mesh, prompts, cut["new_tokens"], cache_len)
        for mesh in (one, cards))
    leaves = list(zip(checkpoint.leaves(k1), checkpoint.leaves(k4)))
    same = (torch.equal(t1, t4.to(t1.device))
            and all(torch.equal(a, b.to(a.device)) for a, b in zip(c1, c4))
            and all(torch.equal(a.to(b.device), b) for x, y in leaves
                    for a, b in zip(x.chunks, y.chunks)))
    smoke.check(same, (cut["arch"], "the 4-card MoE serve is the 4-position one-card serve"))
    del k1, k4, c1, c4
    cross = smoke.MOE_CROSSING
    batch_np = SyntheticLM(cfg.vocab_size, smoke.LLM_TRAIN["seq_len"], cross["global_batch"],
                           seed=seed).batch(0)
    train = same_step_on_one_card_and_cards(
        model, params, {k: torch.from_numpy(v) for k, v in batch_np.items()}, one, cards,
        cross["microbatches"], cut["arch"])
    return {"mesh": dict(cards.shape), "cards": len(cards.cards), **cut,
            "serve": {"same_bits": True, "cache_leaves": len(leaves),
                      "first_tokens": t4[:, :8].tolist(), "decode_step_ms_one_card": ms1,
                      "decode_step_ms_cards": ms4, "launches_by_card": l4},
            "train": {**cross, **train}}


def seq_cards_bits(arch="llama3.2-1b", seq_len=128, global_batch=8, microbatches=2,
                   batch=4, cache_len=128, prompt_len=48, new_tokens=8, seed=0) -> dict:
    """Sequence parallelism over ``model`` (``chip_smoke.seq_rules``) on the
    2 × 2 mesh, on 4 positions of card 0 and on 4 cards: one AdamW step of
    Llama-3.2-1B at published width (``same_step_on_one_card_and_cards``:
    the metrics and every chunk of the new state bit for bit), then a
    prefill of ``prompt_len`` tokens (``prompt_len / 2`` a position) and
    greedy decode steps of its bf16 serving copy (every call's logits, the
    tokens and every cache chunk bit for bit)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distribution import tensor_parallel as tp
    from repro_torch.distribution.sharding import activate
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import Model
    from repro_torch.models.model import cast_floating
    from repro_torch.train import checkpoint

    one = make_local_mesh(2, model=2, device="cuda:0")
    cards = make_local_mesh(2, model=2, devices=[f"cuda:{i}" for i in range(4)])
    cfg = get_config(arch)
    model = Model(cfg)
    data = {k: torch.from_numpy(v) for k, v in
            SyntheticLM(cfg.vocab_size, seq_len, global_batch, seed=seed).batch(0).items()}
    params = model.init(torch.Generator(device="cuda:0").manual_seed(seed), device="cuda:0")
    tp.reset_exchange_counts()
    with activate(cards, smoke.seq_rules()):
        train = same_step_on_one_card_and_cards(model, params, data, one, cards, microbatches,
                                                "split train step")
    counts = tp.exchange_counts()
    smoke.check(counts.get("seq_gather", {}).get("bytes", 0) > 0, ("split", counts))
    params = cast_floating(params, model.compute_dtype)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), device="cuda:0",
                            generator=torch.Generator(device="cuda:0").manual_seed(seed + 1))
    with activate(cards, smoke.seq_rules()):
        (c1, t1, k1, _, ms1), (c4, t4, k4, l4, ms4) = (
            serve_on(model, params, mesh, prompts, new_tokens, cache_len)
            for mesh in (one, cards))
    same = (torch.equal(t1, t4.to(t1.device))
            and all(torch.equal(a, b.to(a.device)) for a, b in zip(c1, c4))
            and all(torch.equal(a.to(b.device), b)
                    for x, y in zip(checkpoint.leaves(k1), checkpoint.leaves(k4))
                    for a, b in zip(x.chunks, y.chunks)))
    smoke.check(same, ("the split 4-card serve is the 4-position one-card serve",))
    return {"arch": arch, "mesh": dict(cards.shape), "cards": len(cards.cards),
            "rules": "ShardingRules(seq_axis='model')", "train": train,
            "train_exchanges": counts,
            "serve": {"prompt_len": prompt_len, "tokens_a_position": prompt_len // 2,
                      "new_tokens": new_tokens, "same_bits": True,
                      "first_tokens": t4[:, :8].tolist(), "decode_step_ms_one_card": ms1,
                      "decode_step_ms_cards": ms4, "launches_by_card": l4}}


def dryrun_cards(cards: bool = True) -> dict:
    """``chip_smoke.py``'s mesh cells of the ``dryrun`` phase over 4 cards,
    one card a position: traced on ``meta`` at the batches the one-card
    phase picks (card 0's free memory less 1 GiB), then each card's peak
    held to its position's traced peak and each card's received bytes to
    the trace's (``chip_smoke.dryrun_mesh_card`` with ``cards=True``).
    ``cards=False``: the one-card cells, every position on card 0, as the
    ``dryrun`` phase runs them, on their own."""
    import torch

    grid = smoke.DRYRUN_MESH
    with torch.cuda.device(0):
        w = torch.ones((64, 64), device="cuda:0")
        _ = (w @ w, w.bfloat16() @ w.bfloat16())
        torch.cuda.synchronize()
        free, _total = torch.cuda.mem_get_info()
    limit = free - smoke.DRYRUN_MARGIN_BYTES
    info = smoke.dryrun_mesh_traces(grid["arch"], grid["data"], grid["model"],
                                    grid["train_layers"], limit)
    return {"limit_bytes": limit, "cells": smoke.dryrun_mesh_cells(
        info, grid["train_layers"], grid["seed"], arch=grid["arch"], cards=cards)}


PHASES = ("copy-modes", "sharded", "sharded-cards", "sharded-train", "sharded-cards-train",
          "capture-across-cards", "data-cards-bits", "llm-train-data", "launch-train-data",
          "model-cards-bits", "mixer-cards-bits", "llm-train-model", "serve-cards-bits",
          "llm-serve-model", "dryrun-cards", "seq-cards-bits", "dryrun-mesh",
          "moe-serve-cards-bits")


def main(argv=None) -> int:
    chosen = list(sys.argv[1:] if argv is None else argv) or list(PHASES)
    unknown = sorted(set(chosen) - set(PHASES))
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; phases: {' '.join(PHASES)}")
    dev = smoke.phase_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    smoke.emit({"phase": "cards", "nvidia_smi": smi})
    if "copy-modes" in chosen:
        smoke.emit({"phase": "copy-modes", **copy_modes()})
    if "sharded" in chosen or "sharded-cards" in chosen:
        one_card, sharded = smoke.phase_sharded(**smoke.SHARDED)
        smoke.emit({"phase": "sharded", **sharded})
        if "sharded-cards" in chosen:
            cards = smoke.phase_sharded_cards(one_card=one_card, **smoke.SHARDED)
            smoke.emit({"phase": "sharded-cards", **cards})
        del one_card
    if "sharded-train" in chosen:
        smoke.emit({"phase": "sharded-train", **smoke.phase_sharded_train(**smoke.SHARDED_TRAIN)})
    if "sharded-cards-train" in chosen:
        smoke.emit({"phase": "sharded-cards-train",
                    **smoke.phase_sharded_train(**smoke.SHARDED_TRAIN, cards=True)})
    if "capture-across-cards" in chosen:
        smoke.emit({"phase": "capture-across-cards",
                    **capture_across_cards(smoke.SHARDED["shards"])})
    if "data-cards-bits" in chosen:
        smoke.emit({"phase": "data-cards-bits", **data_cards_bits()})
    if "llm-train-data" in chosen:
        smoke.emit({"phase": "llm-train-data",
                    **smoke.phase_llm_train_data(**smoke.LLM_TRAIN_DATA)})
    if "launch-train-data" in chosen:
        smoke.emit({"phase": "launch-train-data",
                    **smoke.phase_launch_train_data(**smoke.LAUNCH_TRAIN_DATA)})
    if "model-cards-bits" in chosen:
        smoke.emit({"phase": "model-cards-bits", **data_cards_bits(model_axis=2)})
    if "mixer-cards-bits" in chosen:
        smoke.emit({"phase": "mixer-cards-bits", **mixer_cards_bits()})
    if "llm-train-model" in chosen:
        smoke.emit({"phase": "llm-train-model",
                    **smoke.phase_llm_train_model(**smoke.LLM_TRAIN_MODEL)})
    if "serve-cards-bits" in chosen:
        smoke.emit({"phase": "serve-cards-bits", **serve_cards_bits()})
    if "llm-serve-model" in chosen:
        smoke.emit({"phase": "llm-serve-model",
                    **smoke.phase_llm_serve_model(**smoke.LLM_SERVE_MODEL)})
    if "dryrun-cards" in chosen:
        smoke.emit({"phase": "dryrun-cards", **dryrun_cards()})
    if "dryrun-mesh" in chosen:
        smoke.emit({"phase": "dryrun-mesh", **dryrun_cards(cards=False)})
    if "seq-cards-bits" in chosen:
        smoke.emit({"phase": "seq-cards-bits", **seq_cards_bits()})
    if "moe-serve-cards-bits" in chosen:
        smoke.emit({"phase": "moe-serve-cards-bits", **moe_serve_cards_bits()})
    print(dev["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
