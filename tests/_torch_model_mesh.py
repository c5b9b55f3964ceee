"""Shared by the model-mesh tests (``test_torch_model_mesh*.py``): the
port's step on a ``data`` × ``model`` mesh of the CPU against the
reference's one-device step on the same converted weights and the same
numpy batch, at f32 compute, SGD without momentum (so an updated leaf is
its gradient's image), to ``LOSS_RTOL`` and ``GRAD_RTOL``."""

import dataclasses
import functools

import jax
import torch

from repro.models.model import Model as RefModel
from repro.train.trainer import TrainState as RefTrainState
from repro_torch import convert
from repro_torch.distribution import sharding as sh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import Model
from repro_torch.train import checkpoint, make_train_step, sgd
from repro_torch.train.trainer import TrainState, state_shardings

import _torch_mesh as dm
import _torch_train as tt

MOE_ARCH = dm.MOE_ARCH
MAMBA_ARCH = "jamba-v0.1-52b"
DENSE_MLP_ID = "graphblas-mlp"


def _kv_split(cfg):
    """4 query heads over 2 KV heads: on ``model`` = 2 both split (the
    scaled-down llama's 2 over 1 splits its queries only)."""
    return dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, num_heads=4,
                                                                  num_kv_heads=2))


def _mla_heads4(cfg):
    """4 MLA heads (the scaled-down DeepSeek-V2 has 2, which stay whole on
    ``model`` = 4), so the heads split over 4 positions."""
    return dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, num_heads=4))


def _rwkv_cut_heads(cfg):
    """RWKV-6 heads of 32 at d 64: on ``model`` = 4 the column split of
    ``w_r``/``w_g`` (16 columns a position) cuts a head."""
    return dataclasses.replace(cfg, rwkv=dataclasses.replace(cfg.rwkv, head_dim=32))


def _mamba_sparse_ffn(cfg):
    """Jamba cut to its first period layer (Mamba and a dense FFN), the FFN
    block-pruned to 2 blocks of 16 × 16 a row: the split Mamba beside the
    block-sparse FFN, whole on the home device."""
    from repro.configs import base as ref_base
    from repro_torch.configs import base

    kind = (ref_base if isinstance(cfg, ref_base.ModelConfig) else base).SparsityConfig
    return dataclasses.replace(cfg, num_layers=1, period=cfg.period[:1],
                               sparsity=kind((16, 16), blocks_per_row=2, targets=("ffn",)))


def _pad_slots(jp):
    """Zero 3 of the 4 input blocks of the first 16 hidden units in the
    period's ``w_in`` before pruning: block-row 0 of its output-major form
    keeps one live block, so its ELL row gets a pad slot."""
    ffn = jp["stack"]["period"][0]["ffn"]
    ffn["w_in"] = ffn["w_in"].at[:, 16:, :16].set(0.0)
    return jp


def _moe_tight(cfg):
    """Capacity factor 1 (the scaled-down MoE's 2 keeps every token): a
    group of S tokens holds S/2 a expert, so routing each data index's rows
    alone drops other (token, expert) assignments than the whole batch's
    groups."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))


# a variant's change to the reference's dense params before pruning
BEFORE_PRUNING = {"mamba-sparse-ffn": _pad_slots}
VARIANTS = {None: lambda cfg: cfg, "kv-split": _kv_split, "mla-heads4": _mla_heads4,
            "rwkv-cut-heads": _rwkv_cut_heads, "mamba-sparse-ffn": _mamba_sparse_ffn,
            "moe-tight": _moe_tight}


def grid(data: int, model: int):
    return make_local_mesh(data=data, model=model, device="cpu")


@functools.lru_cache(maxsize=None)
def models(arch: str, variant: str | None = None):
    """(reference model, port model, reference params, port params) at f32
    compute on the same weights, ``variant`` applied to both configs."""
    if arch == DENSE_MLP_ID:
        from repro.configs import graphblas_mlp as ref_mlp
        from repro_torch.configs import graphblas_mlp

        kw = dict(m=64, num_layers=3)
        ref_cfg, cfg = ref_mlp.make_config(**kw), graphblas_mlp.make_config(**kw)
        ref_cfg, cfg = (dataclasses.replace(c, compute_dtype="float32") for c in (ref_cfg, cfg))
    else:
        ref_cfg, cfg = tt.tm.configs(arch, "float32")
    ref_cfg, cfg = VARIANTS[variant](ref_cfg), VARIANTS[variant](cfg)
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    if ref_cfg.sparsity is None:  # jitted: the same draws, faster than op by op
        jp = jax.jit(ref_model.init)(jax.random.key(0))
    else:  # pruning reads values
        jp = ref_model.sparsify(BEFORE_PRUNING.get(variant, lambda x: x)(
            ref_model.init(jax.random.key(0))))
    return ref_model, model, jp, convert.model_params(jp, device="cpu")


def masked_batch(cfg, moe: bool = False, s: int | None = None) -> dict:
    """8 rows (of 64 tokens for a MoE, so each of 2 data indices keeps the
    reference's groups of 256; of ``s`` where given) with labels masked
    unevenly over the rows."""
    host = tt.batch(cfg, b=8, s=s or (64 if moe else 16))
    labels = host["labels"]
    labels[-2:] = -1
    labels[2, : max(1, labels.shape[1] // 2)] = -1
    labels[4, :1] = -1
    return host


@functools.lru_cache(maxsize=None)
def reference_step(arch: str, variant: str | None, microbatches: int, s: int | None = None):
    """(batch, the reference's updated params, metrics and, with one
    microbatch, gradients) of one jitted SGD step on
    :func:`masked_batch`'s rows (of ``s`` tokens where given), as numpy."""
    ref_model, model, jp, _ = models(arch, variant)
    host = masked_batch(model.cfg, moe=model.cfg.moe is not None, s=s)
    jopt, _ = tt.optimizers("sgd", lr=1e-2, momentum=0.0)
    step = jax.jit(tt.ref_make_train_step(ref_model, jopt, microbatches=microbatches))
    js, jm = step(RefTrainState(jp, jopt.init(jp)), tt.as_ref(host))
    grads = None
    if microbatches == 1:  # jitted: op by op, a 6-layer Gemma-3 takes 3x as long
        _, g = jax.jit(jax.value_and_grad(ref_model.loss, has_aux=True, allow_int=True))(
            jp, tt.as_ref(host))
        grads = [tt.host(leaf) for leaf in jax.tree.leaves(g)]
    return host, [tt.host(x) for x in jax.tree.leaves(js.params)], \
        {k: float(v) for k, v in jm.items()}, grads


def same_chunk(sharding, p: int, q: int) -> bool:
    """Whether positions ``p`` and ``q`` hold the same chunk of a leaf."""
    (cp, mp), (cq, mq) = (divmod(x, sharding.model_size) for x in (p, q))
    return ((sharding.data_dim is None or cp == cq)
            and (sharding.model_dim is None or mp == mq))


def whole(chunks_by_position: list, owners: list) -> list:
    """Each leaf's gradient put together from the positions' chunks; the
    copies of a chunk on several positions must be the same bits."""
    out = []
    for j, leaf in enumerate(owners):
        parts = [per[j] for per in chunks_by_position]
        if parts[0] is None:
            out.append(None)
            continue
        for p, a in enumerate(parts):
            for q in range(p):
                if same_chunk(leaf.sharding, p, q):
                    assert torch.equal(a, parts[q]), (j, p, q)
        out.append(sh.Placed(tuple(parts), leaf.sharding).gather("cpu"))
    return out


def placed_state(model, p, mesh, opt):
    state = TrainState(p, opt.init(checkpoint.leaves(p)))
    return sh.place(state, state_shardings(model.cfg, state, mesh))


def check_against_the_reference(arch: str, data: int, model_axis: int, microbatches: int,
                                variant: str | None = None, s: int | None = None
                                ) -> TrainState:
    """One SGD step on a ``data`` × ``model_axis`` mesh against the
    reference's one-device step: loss, ce, ``grad_norm``, every updated
    leaf (gathered) and, with one microbatch, every gradient put together
    from its owners' chunks. Some leaf must be split over ``model`` (where
    ``model_axis`` > 1), the copies of a chunk held by several positions
    are the same bits, and topology passes through. Returns the new
    placed state."""
    host, jparams, jm, jgrads = reference_step(arch, variant, microbatches, s)
    _, model, _, p = models(arch, variant)
    opt = sgd(1e-2, momentum=0.0)
    state = placed_state(model, p, grid(data, model_axis), opt)
    owners = checkpoint.leaves(state.params)
    assert model_axis == 1 or any(x.sharding.model_dim is not None for x in owners)
    rec, seen = dm.recording(opt)
    new, pm = make_train_step(model, rec, microbatches=microbatches)(state, tt.as_port(host))
    tt.assert_metrics_close(jm, pm)
    tt.assert_leaves_close(jparams, dm.gathered(new.params))
    leaves = checkpoint.leaves(new.params)  # copies of a chunk stay the same bits
    whole([[x.chunks[p] for x in leaves] for p in range(len(leaves[0].chunks))], leaves)
    if jgrads is not None:
        tt.assert_leaves_close(jgrads, [tt.host(g) for g in whole(seen, owners)])
    for old, leaf in zip(owners, checkpoint.leaves(new.params)):
        assert isinstance(leaf, sh.Placed) and leaf.sharding == old.sharding
        if not old.is_floating_point():
            assert leaf is old
    return new


def split_fraction(leaf) -> int:
    """How many positions share one copy's worth of a leaf's bytes."""
    s = leaf.sharding
    return (s.data_size if s.data_dim is not None else 1) * \
        (s.model_size if s.model_dim is not None else 1)


def group_params(arch: str, variant: str | None, data: int, model_axis: int) -> list:
    """Each group's params tree on a ``data`` × ``model_axis`` mesh of the
    CPU (``sharding.group_params``), from the converted weights."""
    _, _, _, p = models(arch, variant)
    mesh = grid(data, model_axis)
    placed = sh.place(p, sh.shardings_for(None, mesh, sh.param_pspecs(None, p, mesh)))
    return sh.group_params(placed, checkpoint.leaves(placed), mesh)


def assert_split_as_the_reference(arch: str, variant: str | None, data: int,
                                  model_axis: int) -> int:
    """Every leaf the reference's ``param_pspecs`` splits over ``model`` is
    a ``tensor_parallel.Split`` in each group, along the spec's dim, chunk m
    the whole leaf's slice m (the reference's chunk sizes); every other
    leaf is one tensor. Returns how many leaves are split."""
    from repro.distribution import sharding as jsh
    from repro_torch.distribution import tensor_parallel as tp

    _, _, jp, p = models(arch, variant)
    specs = jax.tree.leaves(jsh.param_pspecs(None, jp, grid(data, model_axis),
                                             jsh.ShardingRules()),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    whole = checkpoint.leaves(p)
    split = 0
    for group in group_params(arch, variant, data, model_axis):
        leaves = checkpoint.leaves(group)
        assert len(specs) == len(leaves) == len(whole)
        for leaf, want, spec in zip(leaves, whole, specs):
            axes = tuple(spec)
            if "model" not in axes:
                assert not isinstance(leaf, tp.Split)
                continue
            dim = axes.index("model")
            size = want.shape[dim] // model_axis
            assert isinstance(leaf, tp.Split) and leaf.dim == dim
            assert [c.shape[dim] for c in leaf.chunks] == [size] * model_axis
            for m, c in enumerate(leaf.chunks):
                assert torch.equal(c, want.narrow(dim, m * size, size))
            split += 1
    return split


def mamba_channels_per_call(data: int, model_axis: int, variant: str | None = None):
    """(the channels of each ``ssm._mamba_gated`` call during the mesh step
    of ``MAMBA_ARCH`` held to the reference, the new placed state)."""
    from unittest import mock

    from repro_torch.models import ssm

    with mock.patch.object(ssm, "_mamba_gated", wraps=ssm._mamba_gated) as spy:
        state = check_against_the_reference(MAMBA_ARCH, data, model_axis, 1, variant)
    return [c.args[3]["D"].shape[-1] for c in spy.call_args_list], state
