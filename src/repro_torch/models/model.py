"""Top-level model API — counterpart of ``repro/models/model.py``: init /
forward / loss / prefill / decode per config.

One class serves every assigned architecture (``--arch <id>``); the
config's layer pattern decides what gets built. Entry points:

  * ``init(generator, device=)``      → params (dense; ``sparsify`` opt-in)
  * ``forward(params, inputs)``       → logits  (B, S, V)
  * ``loss(params, batch)``           → (scalar, metrics)
  * ``init_cache(batch, cache_len)``  → decode cache tree
  * ``prefill(params, inputs, cache)``→ (logits, cache)
  * ``decode_step(params, tok, cache, pos)`` → (logits, cache)
    (both out of place; ``donate_cache=True`` writes the cache in place)

Input modes: ``tokens`` (int ids → embedding table), ``embeddings``
(float (B,S,D) — the VLM/audio frontend stub) and ``features`` (the
paper's MLP: float (B, m) feature vectors, no embedding, logits = output
features).

``use_kernel`` is handed to every FFN ``linear``: ``None`` (default)
runs sparse FFN weights on the SpMM kernels when the tensors are on the
card, ``False`` on the plain products.

A group of the model's mesh (``train.trainer``) passes params whose
leaves split over ``model`` are ``distribution.tensor_parallel.Split``s:
the embedding's d chunks (the lookup concatenates each position's
columns, exact), the head's vocab chunks (an untied ``lm_head``'s own; a
tied table resharded from d to vocab over ``model``, as the reference's
``constrain(w, ("tp", None))``), and the logits stay split into the
vocab-parallel cross entropy (``layers.vocab_parallel_cross_entropy``);
``forward``, ``prefill`` and ``decode_step`` gather them in model order.
Under rules that split the sequence over ``model`` (``sharding.activate``
with ``ShardingRules(seq_axis="model")``), the embedding's rows come out
split along the sequence (each position its chunk of the tokens, the
d-split rows resharded, never gathered on the home), the final norm runs
on each chunk, and the head gathers the sequence on every position for
its vocab chunk. A group's cache (``sharding.group_cache``) goes through
``prefill`` and ``decode_step`` with its split leaves written in place. Everything else
of the reference's distributed lookup and constraints is ``table[ids]``
and the identity. Where the data indices' MoE token groups cross, the
groups of one call run together layer by layer (:meth:`Model.loss_groups`,
:meth:`Model.prefill_groups`, :meth:`Model.decode_groups`), each MoE layer
once over every group's rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distribution import sharding
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    SPARSE,
    Init,
    cross_entropy_loss,
    embed_init,
    init_rms_norm,
    tree_leaves,
    tree_map,
    vocab_parallel_cross_entropy,
)

Params = dict[str, Any]
_SEQ = tfm._SEQ


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype a config names (``"bfloat16"``, ``"float32"``)."""
    return getattr(torch, name)


def cast_floating(tree, dtype: torch.dtype):
    """Floating leaves cast to ``dtype`` (a sparse weight's values through
    ``astype``; index tensors untouched). A tensor already of ``dtype`` is
    returned as it is, so a tree cast once casts again for free."""
    def cast(leaf):
        if isinstance(leaf, SPARSE):
            return leaf.astype(dtype)
        return leaf.to(dtype) if leaf.is_floating_point() else leaf

    return tree_map(cast, tree)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    use_kernel: bool | None = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return dtype_of(self.cfg.compute_dtype)

    # ------------------------------ init ------------------------------------
    def init(self, generator: torch.Generator | None = None, *, device=None) -> Params:
        """Parameters drawn from ``generator`` (``None``: seed 0) on
        ``device`` (``None``: the card), where the generator must live.
        The ``meta`` device draws shapes only and takes no generator."""
        device = resolve_device(device)
        if device.type == "meta":
            generator = None
        elif generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        elif generator.device.type != device.type:
            raise ValueError(f"the generator is on {generator.device}, the parameters go "
                             f"to {device}: draw them where they live")
        rng = Init(generator, device)
        cfg = self.cfg
        dtype = dtype_of(cfg.param_dtype)
        p: Params = {"stack": tfm.init_stack(rng, cfg, dtype)}
        if cfg.input_mode == "tokens":
            p["embed"] = embed_init(rng, cfg.vocab_size, cfg.d_model, dtype)
        if cfg.input_mode != "features":
            p["final_norm"] = init_rms_norm(rng, cfg.d_model)
            if not cfg.tie_embeddings:
                p["lm_head"] = rng.normal((cfg.d_model, cfg.vocab_size), dtype) * 0.02
        return p

    def sparsify(self, params: Params) -> Params:
        """Apply the paper's technique: block-prune targeted weights → BSR."""
        out = dict(params)
        out["stack"] = tfm.sparsify_stack(params["stack"], self.cfg)
        return out

    # ----------------------------- forward ----------------------------------
    def _embed(self, params: Params, inputs: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.input_mode == "tokens":
            table = params["embed"]
            seq = (*inputs.shape[:2], cfg.d_model)
            x = (tp.embed_lookup(table, inputs,
                                 by_sequence=sharding.seq_chunks(_SEQ, seq) > 1)
                 if isinstance(table, tp.Split) else table[inputs.long()])
            x = sharding.constrain(x, _SEQ)
        elif cfg.input_mode == "embeddings":
            x = inputs  # (B, S, D) float stub frontend
        else:  # features — the paper's MLP operates on (B, m)
            x = inputs[:, None, :] if inputs.dim() == 2 else inputs
        return x.to(self.compute_dtype)

    def _head(self, params: Params, x: torch.Tensor):
        """The logits, or, when the head is split over ``model``, their
        vocab chunks (a ``tensor_parallel.Split`` along the last dim)."""
        cfg = self.cfg
        if cfg.input_mode == "features":
            return x  # output features ARE the logits (vocab = m)
        x = tfm._norm(x, params["final_norm"], cfg.norm_eps)
        w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        if isinstance(w, tp.Split):
            if cfg.tie_embeddings:  # the table d over model → vocab over model
                if w.shape[0] % len(w.chunks):
                    return torch.einsum("bsd,vd->bsv", tp.whole_on_home(x),
                                        tp.all_gather(w.chunks, 1, x.device))
                chunks = tp.reshard(w.chunks, 1, 0)
            else:
                chunks = w.chunks
            xs = tp.region_input(x, w.devices)
            spec = "bsd,vd->bsv" if cfg.tie_embeddings else "bsd,dv->bsv"
            return tp.Split(tuple(torch.einsum(spec, xm, c.to(x.dtype))
                                  for xm, c in zip(xs, chunks)), 2)
        x = tp.whole_on_home(x)
        if cfg.tie_embeddings:
            return torch.einsum("bsd,vd->bsv", x, w.to(x.dtype))
        return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))

    def forward(self, params: Params, inputs: torch.Tensor) -> torch.Tensor:
        return self.forward_with_aux(params, inputs)[0]

    def forward_with_aux(self, params: Params,
                         inputs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        logits, aux = self._logits(params, inputs)
        return _whole(logits, inputs.device), aux

    def _logits(self, params: Params, inputs: torch.Tensor):
        params = cast_floating(params, self.compute_dtype)
        x = self._embed(params, inputs)
        x, aux = tfm.apply_stack(params["stack"], self.cfg, x, use_kernel=self.use_kernel)
        return self._head(params, x), aux

    # ------------------------------- loss -----------------------------------
    def loss(self, params: Params, batch: dict[str, torch.Tensor], *,
             shares=None) -> tuple[torch.Tensor, dict]:
        """batch: {"inputs": tokens/embeddings, "labels": (B, S) int}.

        ``shares``: ``(ce share, aux share)``, device scalars, when
        ``batch`` is one position's rows of a global batch on the data
        mesh: the ce is weighted by the position's share of the unmasked
        labels and the MoE aux loss by its share of the token groups, so
        the positions' losses and metrics add up to the global ones."""
        logits, aux = self._logits(params, batch["inputs"])
        ce = _cross_entropy(logits, batch["labels"])
        if shares is not None:
            ce, aux = shares[0] * ce, shares[1] * aux
        aux_w = self.cfg.moe.aux_loss_weight if self.cfg.moe else 0.0
        return ce + aux_w * aux, {"ce": ce, "moe_aux": aux}

    # ------------------------------ serving ---------------------------------
    def init_cache(self, batch: int, cache_len: int, dtype=None, *, device=None) -> Params:
        """A decode cache on ``device`` (``None``: the card)."""
        return tfm.init_stack_cache(self.cfg, batch, cache_len, dtype or self.compute_dtype,
                                    resolve_device(device))

    def prefill(self, params: Params, inputs: torch.Tensor, cache: Params, *,
                donate_cache: bool = False) -> tuple[torch.Tensor, Params]:
        """Process the prompt, fill the cache; logits for the LAST position.
        The caller's ``cache`` is left as it was, or, with
        ``donate_cache=True``, written in place and returned (its own
        tensors, the same values)."""
        params = cast_floating(params, self.compute_dtype)
        x = self._embed(params, inputs)
        x, cache = tfm.prefill_stack(params["stack"], self.cfg, x, cache,
                                     use_kernel=self.use_kernel, donate=donate_cache)
        return _whole(self._head(params, tp.last_tokens(x)), x.device), cache

    def decode_step(self, params: Params, token: torch.Tensor, cache: Params, pos, *,
                    donate_cache: bool = False) -> tuple[torch.Tensor, Params]:
        """One new token (B,) int (or (B,1,D) embeddings) at position
        ``pos`` (an int or a 0-d tensor); ``donate_cache`` as ``prefill``."""
        params = cast_floating(params, self.compute_dtype)
        if token.dim() == 1:
            token = token[:, None]
        x = self._embed(params, token)
        x, cache = tfm.decode_stack(params["stack"], self.cfg, x, cache, int(pos),
                                    use_kernel=self.use_kernel, donate=donate_cache)
        return _whole(self._head(params, x), x.device)[:, 0], cache

    # ------------- groups whose MoE token groups cross data indices ------------
    # ``run`` (a ``sharding.GroupRun``) holds the groups of one call; each
    # group's params, rows and cache are given in data order, and a group
    # that does not compute (``run.computes``) gets None back.

    def _embed_groups(self, run, params: list, inputs: list) -> tuple[list, list]:
        ps, xs = [None] * run.groups, [None] * run.groups
        for c in range(run.groups):
            if run.computes(c):
                with run.within(c):
                    ps[c] = cast_floating(params[c], self.compute_dtype)
                    xs[c] = self._embed(ps[c], inputs[c])
        return ps, xs

    def _stack_groups(self, run, ps: list, xs: list, caches=None, pos=None):
        return tfm.stack_groups(run, [None if p is None else p["stack"] for p in ps], self.cfg,
                                xs, caches, pos=pos, use_kernel=self.use_kernel)

    def loss_groups(self, run, params: list, batches: list, shares: list) -> list:
        """:meth:`loss` of each group's rows, the groups computed together
        layer by layer (``transformer.stack_groups``): each group's ce
        weighted by its share ``shares[c]`` of the unmasked labels; the MoE
        aux loss, computed once over the whole batch's token groups (the
        reference's E · mean over every group), enters group 0's loss and
        ``moe_aux`` once (the other groups' ``moe_aux`` are 0), so the
        groups' losses and metrics add up to the global ones. Returns each
        group's ``(loss, metrics)``."""
        ps, xs = self._embed_groups(run, params, [b["inputs"] for b in batches])
        xs, aux = self._stack_groups(run, ps, xs)
        out = []
        for c in range(run.groups):
            if xs[c] is None:
                out.append(None)
                continue
            with run.within(c):
                ce = shares[c] * _cross_entropy(self._head(ps[c], xs[c]), batches[c]["labels"])
                if c == 0:
                    out.append((ce + self.cfg.moe.aux_loss_weight * aux,
                                {"ce": ce, "moe_aux": aux}))
                else:
                    out.append((ce, {"ce": ce, "moe_aux": torch.zeros_like(ce)}))
        return out

    def prefill_groups(self, run, params: list, inputs: list, caches: list) -> list:
        """:meth:`prefill` (``donate_cache=True``) of each group's rows into
        its cache, the groups computed together layer by layer: each
        group's logits for its last position."""
        ps, xs = self._embed_groups(run, params, inputs)
        xs, _ = self._stack_groups(run, ps, xs, caches)
        return self._head_groups(run, ps, [None if x is None else tp.last_tokens(x)
                                           for x in xs], xs)

    def decode_groups(self, run, params: list, tokens: list, caches: list, pos) -> list:
        """:meth:`decode_step` (``donate_cache=True``) of each group's tokens,
        the groups computed together layer by layer: each group's logits."""
        tokens = [t[:, None] if t.dim() == 1 else t for t in tokens]
        ps, xs = self._embed_groups(run, params, tokens)
        xs, _ = self._stack_groups(run, ps, xs, caches, int(pos))
        return [None if lg is None else lg[:, 0] for lg in self._head_groups(run, ps, xs, xs)]

    def _head_groups(self, run, ps: list, heads: list, xs: list) -> list:
        out = []
        for c, (h, x) in enumerate(zip(heads, xs)):
            if h is None:
                out.append(None)
                continue
            with run.within(c):
                out.append(_whole(self._head(ps[c], h), x.device))
        return out

    # ----------------------------- accounting -------------------------------
    def param_count(self) -> int:
        """Parameters of the dense model, counted on the ``meta`` device
        (shapes only; no memory is allocated)."""
        return sum(math.prod(leaf.shape) for leaf in tree_leaves(self.init(device="meta")))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        cfg = self.cfg
        total = self.param_count()
        if cfg.moe is None:
            return total
        n_moe = sum(1 for s in cfg.layer_specs() if s.ffn == "moe")
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        per_expert = cfg.d_model * cfg.moe.d_expert * (3 if cfg.glu else 2)
        return total - n_moe * (e - k) * per_expert


def _cross_entropy(logits, labels: torch.Tensor) -> torch.Tensor:
    """The loss's ce: vocab-parallel over a head split over ``model``."""
    if isinstance(logits, tp.Split):
        return vocab_parallel_cross_entropy(logits.chunks, labels, z_loss=1e-4)
    return cross_entropy_loss(logits, labels, z_loss=1e-4)


def _whole(logits, device) -> torch.Tensor:
    """Logits whole on ``device``: a vocab-split head's chunks gathered in
    model order (exact)."""
    if isinstance(logits, tp.Split):
        return tp.all_gather(logits.chunks, 2, device)
    return logits


def build(name_or_cfg) -> Model:
    if isinstance(name_or_cfg, ModelConfig):
        return Model(name_or_cfg)
    from repro_torch.configs import get_config

    return Model(get_config(name_or_cfg))
