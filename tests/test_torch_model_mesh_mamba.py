"""Mamba on the model mesh: the scaled-down ``jamba-v0.1-52b`` with its
whole period (7 Mamba layers, a GQA layer, 4 MoE layers of 4 experts) on
``(data, model)`` = (1, 2), (1, 4) and (2, 2), one SGD step against the
reference's one-device step at f32 compute, to ``LOSS_RTOL`` and
``GRAD_RTOL``; the MoE batches keep the reference's token groups (64
tokens a row). ``di`` is the split dim: ``in_proj``, ``dt_proj`` and the
per-channel leaves column-parallel, ``x_proj`` and ``out_proj``
row-parallel. ``in_proj``'s contiguous chunks of ``[x_in | z]`` are
regrouped (exact) so each position holds its own channels of both — the
trap is pinned on integer-valued inputs. (A split Mamba beside a
block-sparse FFN: ``test_torch_model_mesh_mamba_sparse.py``.)"""

import numpy as np
import pytest
import torch

from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models import ssm

import _torch_model_mesh as mm

ARCH = mm.MAMBA_ARCH


@pytest.mark.parametrize("data,model", [(1, 2), (1, 4), (2, 2)])
def test_jamba_on_a_model_mesh_matches_the_reference(data, model):
    di = 2 * mm.models(ARCH)[1].cfg.d_model
    # 7 Mamba layers a group, each run once a position on its di/M channels
    assert mm.mamba_channels_per_call(data, model)[0] == [di // model] * 7 * model * data


@pytest.mark.parametrize("m", [2, 4])
def test_each_position_gets_its_own_x_in_and_z_channels_of_in_proj(m):
    """The trap: ``in_proj`` (d, 2·di) splits into contiguous column ranges
    of ``[x_in | z]``; after the regroup, position k holds channels
    ``[k·di/M, (k+1)·di/M)`` of both, exactly (integer-valued inputs), the
    exchange counted as ``"regroup"`` (each position keeps one of its
    pieces on ``model`` = 2 and moves the other), and the gradients come
    back to the chunks exactly."""
    rng = np.random.default_rng(9)
    d, di, b, s = 8, 16, 2, 3
    x = torch.from_numpy(rng.integers(-3, 4, (b, s, d)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-3, 4, (d, 2 * di)).astype(np.float32))
    chunks = [c.clone().requires_grad_() for c in w.chunk(m, 1)]
    tp.reset_exchange_counts()
    got = ssm.mamba_channels({"in_proj": tp.Split(tuple(chunks), 1)}, x)
    xz = x @ w
    width = di // m
    moved = 0
    for k, (x_in, z) in enumerate(got):
        assert torch.equal(x_in, xz[..., k * width:(k + 1) * width])
        assert torch.equal(z, xz[..., di + k * width:di + (k + 1) * width])
    pieces_kept = sum(1 for k in range(m) for part in range(2)
                      if divmod(part * m + k, 2)[0] == k)
    moved = (2 * m - pieces_kept) * b * s * width * 4
    assert tp.exchange_counts()["regroup"] == {"calls": 1, "bytes": moved}
    g = torch.from_numpy(rng.integers(-3, 4, (b, s, 2 * di)).astype(np.float32))
    torch.autograd.backward([t for pair in got for t in pair],
                            [part for k in range(m) for part in
                             (g[..., k * width:(k + 1) * width],
                              g[..., di + k * width:di + (k + 1) * width])])
    want = torch.einsum("bsd,bso->do", x, g)
    assert torch.equal(torch.cat([c.grad for c in chunks], 1), want)
    assert tp.exchange_counts()["regroup"] == {"calls": 2, "bytes": 2 * moved}


def test_in_proj_split_with_whole_channels_runs_the_layer_on_the_home_device():
    """d 5 on ``model`` = 4: ``2·di`` = 20 splits and ``di`` = 10 does not,
    so ``param_pspecs`` splits ``in_proj`` alone. Its column products are
    gathered (exact) and the layer runs whole: the output, the decode
    state it leaves (whole, on the home device) and every gradient equal
    the whole layer's to f32 rounding."""
    from repro_torch.configs.base import MambaConfig
    from repro_torch.models.layers import Init

    cfg = MambaConfig(d_state=4, d_conv=2, expand=2)
    p = ssm.init_mamba(Init(torch.Generator().manual_seed(3), torch.device("cpu")), 5, cfg)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 7, 5)).astype(np.float32))
    whole = {k: w.clone().requires_grad_() for k, w in p.items()}
    want, want_state = ssm.apply_mamba(whole, cfg, x)
    chunks = [c.clone().requires_grad_() for c in p["in_proj"].chunk(4, 1)]
    split = {**{k: w.clone().requires_grad_() for k, w in p.items() if k != "in_proj"},
             "in_proj": tp.Split(tuple(chunks), 1)}
    tp.reset_exchange_counts()
    got, state = ssm.apply_mamba(split, cfg, x)
    assert set(tp.exchange_counts()) == {"fan_out", "all_gather"}
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert set(state) == set(want_state) == {"conv", "ssm"}
    for k, v in want_state.items():
        torch.testing.assert_close(state[k], v, rtol=1e-6, atol=1e-6)
    g = torch.ones_like(want)
    want.backward(g)
    got.backward(g)
    torch.testing.assert_close(torch.cat([c.grad for c in chunks], 1), whole["in_proj"].grad,
                               rtol=1e-5, atol=1e-6)
    for k in p:
        if k != "in_proj":
            torch.testing.assert_close(split[k].grad, whole[k].grad, rtol=1e-5, atol=1e-6)
