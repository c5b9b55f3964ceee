"""Gradient collectives — counterpart of ``repro/distribution/collectives.py``,
run over S shards in one process, as ``repro_torch.plan.sharded`` runs
its shards.

The reference calls these inside ``shard_map``, one program a device,
with ``pmax``/``psum`` over a named mesh axis. Here the axis is the
leading dim of the argument: S per-shard tensors, stacked (a sequence of
S tensors is stacked first). ``pmax`` is a max over that dim and the
int32 ``psum`` a sum over it; a reduced value every shard holds comes
back expanded over the S dim (a view), as the reference's per-device
results line up.

``compressed_psum_mean``: an int8 error-feedback all-reduce. Each shard
quantizes its gradient plus its carried error with one shared scale
(the max over shards of max|x| / 127), the int8 payloads are summed in
int32, and the quantization error stays with the shard for the next
step. ``torch.round`` and ``jnp.round`` both round half to even, so the
int8 payloads equal the reference's exactly.

On the model's data mesh the axis is the mesh's positions: with
``mesh=``, :func:`compressed_psum_mean` and its tree form take one tensor
(or tree) a position, each on its position's device, and give one back
a position. The pmax is exact in any order, the int32 sum is added in
card order on position 0's device, and every elementwise step is the
leading-dim form's, so the two give the same bits.

``bucketed``: gradient leaves grouped into buckets of at most
``bucket_bytes`` (the launch granularity of bucketed all-reduces); a
placed tree's leaves count their whole bytes.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.distribution import peer


def _shards(x) -> torch.Tensor:
    return torch.stack(list(x)) if isinstance(x, (list, tuple)) else x


def _per_shard(value: torch.Tensor, n: int) -> torch.Tensor:
    """``value``, which every shard holds, over a leading dim of ``n`` shards."""
    return value.expand(n, *value.shape)


def quantize_int8(x: torch.Tensor | Sequence[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of S shards (``x``: (S, ...)) with one
    shared scale, the max over shards of max|x| over 127: ``(q (S, ...)
    int8, scale (S,))``."""
    x = _shards(x)
    amax = torch.amax(torch.abs(x).reshape(x.shape[0], -1), dim=1).max()  # the pmax
    scale = torch.clamp_min(amax / 127.0, 1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, _per_shard(scale, x.shape[0])


def compressed_psum_mean(x, err, *, mesh=None, axis: str = "data"):
    """Mean of S shards' ``x`` over int8 payloads, with error feedback:
    ``(mean (S, ...), new_err (S, ...))``; ``err`` is each shard's carried
    quantization error (zeros at the first step). With ``mesh``: over the
    mesh's positions along ``axis`` (it must span them), ``x`` and
    ``err`` one tensor a position on its device; ``(means, new_errs)``
    are lists of one a position."""
    if mesh is not None:
        return _positions_psum_mean(list(x), list(err), mesh, axis)
    x, err = _shards(x), _shards(err)
    n = x.shape[0]
    xe = x + err
    q, scale = quantize_int8(xe)
    scale = scale[0]
    new_err = xe - q.to(x.dtype) * scale
    total = torch.sum(q.to(torch.int32), dim=0, dtype=torch.int32)  # the int32 psum
    mean = total.to(x.dtype) * (scale / n)
    return _per_shard(mean, n), new_err


def _positions_psum_mean(x: list, err: list, mesh, axis: str) -> tuple[list, list]:
    devices = mesh.devices
    n = len(devices)
    if mesh.shape.get(axis) != n or len(x) != n or len(err) != n:
        raise ValueError(f"one tensor a position of the {axis!r} axis, which must span the "
                         f"mesh {mesh.shape}: got {len(x)} tensors and {len(err)} errors")
    xe = [a + e for a, e in zip(x, err)]
    home = devices[0]
    amax = torch.stack([peer.to(torch.amax(torch.abs(v).reshape(-1)), home) for v in xe]).max()
    scale = torch.clamp_min(amax / 127.0, 1e-30)  # the pmax, then the shared scale
    new_err, payloads = [], []
    for v, d in zip(xe, devices):
        s = peer.to(scale, d)
        q = torch.clamp(torch.round(v / s), -127, 127).to(torch.int8)
        new_err.append(v - q.to(v.dtype) * s)
        payloads.append(peer.to(q.to(torch.int32), home))
    total = peer.shard_order_sum(payloads)  # the int32 psum, card order
    mean = total.to(x[0].dtype) * (scale / n)
    return [peer.copy_into(torch.empty_like(mean, device=d), mean) for d in devices], new_err


def compressed_psum_mean_tree(grads: Any, err_tree: Any, *, mesh=None,
                              axis: str = "data") -> tuple[Any, Any]:
    """:func:`compressed_psum_mean` leaf by leaf over a tree of per-shard
    gradients (leaves (S, ...)); the error tree mirrors it. With
    ``mesh``: ``grads`` and ``err_tree`` are sequences of one tree a
    position, and so are the two results."""
    from repro_torch.train.checkpoint import leaves, with_leaves

    if mesh is None:
        out = [compressed_psum_mean(g, e) for g, e in zip(leaves(grads), leaves(err_tree))]
        return with_leaves(grads, [m for m, _ in out]), with_leaves(grads, [e for _, e in out])
    per_leaf = [compressed_psum_mean(g, e, mesh=mesh, axis=axis)
                for g, e in zip(zip(*map(leaves, grads)), zip(*map(leaves, err_tree)))]
    return ([with_leaves(grads[c], [m[c] for m, _ in per_leaf]) for c in range(len(grads))],
            [with_leaves(grads[c], [e[c] for _, e in per_leaf]) for c in range(len(grads))])


def init_error_state(grads_like: Any) -> Any:
    """Zeros shaped and typed like every leaf of ``grads_like``."""
    from repro_torch.train.checkpoint import map_with_path

    return map_with_path(lambda _path, leaf: torch.zeros(leaf.shape, dtype=leaf.dtype,
                                                         device=leaf.device), grads_like)


def bucketed(tree: Any, bucket_bytes: int = 32 * 1024 * 1024) -> list[list]:
    """The leaves of ``tree`` in order, grouped into buckets of at most
    ``bucket_bytes`` (a leaf larger than that gets a bucket of its own):
    a list of lists of ``(path, leaf)``, ``path`` the leaf's names."""
    from repro_torch.train.checkpoint import SEP, map_with_path

    items: list = []
    map_with_path(lambda path, leaf: items.append((tuple(path.split(SEP)), leaf)), tree)
    buckets, cur, cur_bytes = [], [], 0
    for path, leaf in items:
        nbytes = leaf.numel() * leaf.element_size()
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append((path, leaf))
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets
