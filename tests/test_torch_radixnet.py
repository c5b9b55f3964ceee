"""The port's RadiX-net generator against the reference, bit for bit.

``repro_torch.data.radixnet`` keeps its own copy of the topology, input
panel and numpy oracle; here the copy and the original must agree
exactly, and the weights it builds must equal the reference's arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dnn as jdnn
from repro.data import radixnet as jrx
from repro_torch.core import dnn
from repro_torch.data import radixnet as rx


@pytest.mark.parametrize("neurons", [32, 64, 256, 1024, 2048, 16384])
def test_connectivity_bit_identical(neurons):
    assert rx.num_phases(neurons) == jrx.num_phases(neurons)
    for layer in range(rx.num_phases(neurons) + 1):
        got = rx.radixnet_connectivity(neurons, layer)
        want = jrx.radixnet_connectivity(neurons, layer)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("neurons,n_inputs,density,seed",
                         [(256, 50, 0.3, 5), (1024, 37, 0.4, 0), (64, 8, 0.5, 11)])
def test_input_panel_bit_identical(neurons, n_inputs, density, seed):
    got = rx.radixnet_input_panel(neurons, n_inputs, density=density, seed=seed)
    want = jrx.radixnet_input_panel(neurons, n_inputs, density=density, seed=seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_spec_constants_match():
    for neurons in (64, 1024, 4096, 16384, 65536):
        assert rx.RadixNetSpec(neurons, 3).bias == jrx.RadixNetSpec(neurons, 3).bias
        assert rx.challenge_bias(neurons) == jrx.challenge_bias(neurons)
    assert rx.RadixNetSpec(1024, 120).edges == jrx.RadixNetSpec(1024, 120).edges


@pytest.mark.parametrize("neurons,bs", [(64, 8), (64, 16), (256, 16), (1024, 16)])
def test_conn_to_bsr_bit_identical(neurons, bs):
    for layer in range(rx.num_phases(neurons)):
        conn = rx.radixnet_connectivity(neurons, layer)
        got = rx.conn_to_bsr(conn, block_size=bs, device="cpu")
        want = jrx.conn_to_bsr(conn, block_size=bs)
        np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(want.blocks))
        np.testing.assert_array_equal(got.col_idx.numpy(), np.asarray(want.col_idx))
        np.testing.assert_array_equal(got.block_mask.numpy(),
                                      np.asarray(want.block_mask).astype(bool))


def test_weights_and_reference_bit_identical():
    spec, jspec = rx.RadixNetSpec(256, 5), jrx.RadixNetSpec(256, 5)
    ws, bs = rx.radixnet_weights(spec, device="cpu")
    jws, jbs = jrx.radixnet_weights(jspec)
    assert len({w.max_blocks_per_row for w in ws}) == 1
    assert ws[0] is ws[rx.num_phases(256)]  # one object per phase
    got, want = dnn.stack_bsr(ws), jdnn.stack_bsr(jws)
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(want.blocks))
    np.testing.assert_array_equal(got.col_idx.numpy(), np.asarray(want.col_idx))
    np.testing.assert_array_equal(torch.stack(bs).numpy(), np.asarray(jnp.stack(jbs)))
    y0 = rx.radixnet_input_panel(256, 30, density=0.3, seed=3)
    ry, rc = rx.radixnet_reference(spec, y0)
    jy, jc = jrx.radixnet_reference(jspec, y0)
    np.testing.assert_array_equal(ry, jy)
    np.testing.assert_array_equal(rc, jc)


@pytest.mark.parametrize("neurons", [64, 1024])
def test_first_layer_bit_exact(neurons):
    """{0, 1} inputs × the dyadic 1/16 weight: layer 1 is exact in f32
    under any summation order, so the port's forward equals the oracle."""
    spec = rx.RadixNetSpec(neurons, 1)
    ws, bs = rx.radixnet_weights(spec, device="cpu")
    y0 = rx.radixnet_input_panel(neurons, 40, density=0.3, seed=0)
    l1 = rx.reference_forward([rx.radixnet_connectivity(neurons, 0)], [spec.bias], y0)
    got = dnn.dnn_forward(ws, bs, torch.from_numpy(y0)).numpy()
    np.testing.assert_array_equal(got, l1)


def test_entry_points_need_a_device_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rx.radixnet_weights(rx.RadixNetSpec(64, 2))
