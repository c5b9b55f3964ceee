"""Shared by the model-stack parity tests (``test_torch_models*.py``,
``test_torch_llm_engine.py``): the reference's and the port's model on
the same converted weights and the same numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import graphblas_mlp as ref_graphblas_mlp
from repro.models.model import Model as RefModel
from repro_torch import convert
from repro_torch.configs import get_config, graphblas_mlp
from repro_torch.models import Model

B, S, CACHE = 2, 12, 32
# the sparsified paper MLP: 4 × 4 blocks of 16, 2 kept a block-row
SPARSE_MLP = dict(m=64, num_layers=2, inverse_sparsity=2, block=16)
SPARSE_MLP_ID = "graphblas-mlp-sparse"
F32_ROW_RTOL = 1e-4  # f32 compute: max|Δ| per row <= 1e-4 × the row's max |reference|
BF16_TOL = 2e-2  # bf16 compute: the reference's own prefill/decode tolerance


def configs(arch: str, dtype: str):
    """(reference config, port config) at ``scaled_down()`` (the sparse
    MLP at its own size) with ``compute_dtype`` set to ``dtype``."""
    if arch == SPARSE_MLP_ID:
        ref, port = ref_graphblas_mlp.make_config(**SPARSE_MLP), graphblas_mlp.make_config(**SPARSE_MLP)
    else:
        ref, port = ref_get_config(arch).scaled_down(), get_config(arch).scaled_down()
    return (dataclasses.replace(ref, compute_dtype=dtype),
            dataclasses.replace(port, compute_dtype=dtype))


def ref_params(ref_model: RefModel, seed: int = 0):
    params = ref_model.init(jax.random.key(seed))
    if ref_model.cfg.sparsity is not None:
        params = ref_model.sparsify(params)
    return params


def inputs(cfg, seed: int = 0, b: int = B, s: int = S + 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.input_mode == "features":
        return rng.random((b, cfg.d_model), dtype=np.float32)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def run_both(arch: str, dtype: str, jp) -> dict:
    """forward, prefill's last logits and decode_step's logits of both
    packages on the reference's params ``jp`` (converted for the port) and
    the same inputs, as f32 numpy arrays (``{name: (reference, port)}``),
    and the two caches' byte counts."""
    from repro.serve.engine import cache_nbytes as ref_cache_nbytes
    from repro_torch.serve.engine import cache_nbytes

    ref_cfg, cfg = configs(arch, dtype)
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    p = convert.model_params(jp, device="cpu")
    inp = inputs(cfg)
    out = {"forward": (f32(ref_model.forward(jp, jnp.asarray(inp))),
                       f32(model.forward(p, torch.from_numpy(inp))))}
    if cfg.input_mode == "features":  # one position: prefill it, decode another
        prefix, nxt = inp, inputs(cfg, seed=1)
    else:
        prefix, nxt = inp[:, :S], inp[:, S]
    if cfg.input_mode == "embeddings":
        nxt = inp[:, S:S + 1]
    jc = ref_model.init_cache(B, CACHE)
    c = model.init_cache(B, CACHE, device="cpu")
    jl, jc = ref_model.prefill(jp, jnp.asarray(prefix), jc)
    pl, c = model.prefill(p, torch.from_numpy(np.ascontiguousarray(prefix)), c)
    out["prefill"] = (f32(jl[:, -1]), f32(pl[:, -1]))
    jd, jc = ref_model.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(S, jnp.int32))
    d, c = model.decode_step(p, torch.from_numpy(np.ascontiguousarray(nxt)), c, S)
    out["decode"] = (f32(jd), f32(d))
    out["cache_bytes"] = (ref_cache_nbytes(jc), cache_nbytes(c))
    return out


def assert_logits_match(ref: np.ndarray, got: np.ndarray, dtype: str) -> None:
    """f32: every row (over the last axis) within 1e-4 of its max |ref|;
    bf16: the reference's ``allclose(rtol=2e-2, atol=2e-2)``."""
    assert ref.shape == got.shape and np.isfinite(got).all()
    if dtype == "float32":
        scale = np.abs(ref).max(axis=-1, keepdims=True)
        err = np.abs(got - ref).max(axis=-1, keepdims=True)
        assert (err <= F32_ROW_RTOL * scale).all(), float((err / scale).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=BF16_TOL, atol=BF16_TOL)


def layer_chain(arch: str, dtype: str, jp) -> list:
    """Each layer of the stack in both packages on the reference's own
    hidden state (the reference's previous layer output): ``[(spec,
    reference output, port output)]`` as f32 numpy arrays. A difference
    here is the layer's own, not one carried from an earlier layer."""
    from repro.models import transformer as ref_tfm
    from repro.models.model import cast_floating as ref_cast
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import tree_index
    from repro_torch.models.model import cast_floating

    ref_cfg, cfg = configs(arch, dtype)
    jdt, dt = jnp.dtype(dtype), getattr(torch, dtype)
    jpc = ref_cast(jp, jdt)
    pc = cast_floating(convert.model_params(jp, device="cpu"), dt)
    inp = inputs(cfg)
    if cfg.input_mode == "tokens":
        jx = jpc["embed"][inp]
    else:
        jx = jnp.asarray(inp[:, None] if cfg.input_mode == "features" else inp).astype(jdt)
    stack, ref_stack = pc["stack"], jpc["stack"]
    layers = [(ref_stack["head"][i], stack["head"][i], s) for i, s in enumerate(cfg.head)]
    for r in range(cfg.n_periods):
        layers += [(jax.tree.map(lambda a: a[r], ref_stack["period"][i]),
                    tree_index(stack["period"][i], r), s) for i, s in enumerate(cfg.period)]
    layers += [(ref_stack["tail"][i], stack["tail"][i], s) for i, s in enumerate(cfg.tail)]
    out = []
    for jl, lp, spec in layers:
        x = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(dt)
        jx, _ = ref_tfm.apply_layer(jl, ref_cfg, spec, jx)
        y, _ = tfm.apply_layer(lp, cfg, spec, x)
        out.append((spec, f32(jx), f32(y)))
    return out


DTYPES = ("float32", "bfloat16")
OUTPUTS = ("forward", "prefill", "decode")
# At bf16, a one-ulp difference in a matmul's summation order (the two
# packages' GEMMs accumulate in other orders; every layer on the same
# input agrees to an ulp, ``layer_chain``) flips one of jamba's top-2 MoE
# routing choices downstream, and its forward logits then move by 0.15
# (its reference's own bf16 logits lie 0.07 from its f32 logits): that
# case is held layer by layer instead of end to end.
BF16_ROUTING_FLIPS = {("jamba-v0.1-52b", "forward")}


def cases(archs) -> list:
    """(arch, dtype, output) of every end-to-end logits comparison."""
    return [(a, d, o) for a in archs for d in DTYPES for o in OUTPUTS
            if d == "float32" or (a, o) not in BF16_ROUTING_FLIPS]


class Runs:
    """Both packages' outputs, computed once per (arch, dtype) on the
    reference's params, drawn once per arch."""

    def __init__(self):
        self._params, self._out, self._chain = {}, {}, {}

    def params(self, arch):
        if arch not in self._params:
            self._params[arch] = ref_params(RefModel(configs(arch, "float32")[0]))
        return self._params[arch]

    def outputs(self, arch, dtype) -> dict:
        if (arch, dtype) not in self._out:
            self._out[arch, dtype] = run_both(arch, dtype, self.params(arch))
        return self._out[arch, dtype]

    def loss(self, arch) -> tuple:
        """``Model.loss`` of both packages at f32 compute on labels with
        masked (-1) positions: ((total, ce, moe_aux) of the reference,
        the same of the port)."""
        ref_cfg, cfg = configs(arch, "float32")
        jp = self.params(arch)
        inp = inputs(cfg, s=S)
        labels = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        labels[:, :2] = -1
        jt, jm = RefModel(ref_cfg).loss(jp, {"inputs": jnp.asarray(inp),
                                             "labels": jnp.asarray(labels)})
        t, m = Model(cfg).loss(convert.model_params(jp), {"inputs": torch.from_numpy(inp),
                                                          "labels": torch.from_numpy(labels)})
        return ((float(jt), float(jm["ce"]), float(jm["moe_aux"])),
                (float(t), float(m["ce"]), float(m["moe_aux"])))

    def chain(self, arch, dtype) -> list:
        if (arch, dtype) not in self._chain:
            self._chain[arch, dtype] = layer_chain(arch, dtype, self.params(arch))
        return self._chain[arch, dtype]
