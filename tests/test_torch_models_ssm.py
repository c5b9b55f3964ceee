"""``test_torch_models.py``'s comparisons for the attention-free and
hybrid stacks: RWKV-6 (chunked WKV at prefill, the recurrent step at
decode) and Jamba (Mamba, attention and MoE layers). Jamba's bf16
forward is held layer by layer (``_torch_models.BF16_ROUTING_FLIPS``)."""

import numpy as np
import pytest

import _torch_models as tm

ARCHS = ("rwkv6-3b", "jamba-v0.1-52b")


@pytest.fixture(scope="module")
def runs():
    return tm.Runs()


@pytest.mark.parametrize("arch,dtype,output", tm.cases(ARCHS))
def test_logits_match_reference(runs, arch, dtype, output):
    tm.assert_logits_match(*runs.outputs(arch, dtype)[output], dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_bytes_and_bf16_layers_match_reference(runs, arch):
    ref_bytes, port_bytes = runs.outputs(arch, "bfloat16")["cache_bytes"]
    assert port_bytes == ref_bytes
    for spec, ref, got in runs.chain(arch, "bfloat16"):
        np.testing.assert_allclose(got, ref, rtol=tm.BF16_TOL, atol=tm.BF16_TOL, err_msg=str(spec))
