"""``test_torch_models.py``'s comparisons for the MoE transformers:
DeepSeek-V2 (MLA attention, its absorbed decode, shared experts, a dense
first layer) and Moonlight (GQA, 64-expert routing at scaled-down size)."""

import numpy as np
import pytest

import _torch_models as tm

ARCHS = ("deepseek-v2-236b", "moonshot-v1-16b-a3b")


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


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_aux_loss_match_reference(runs, arch):
    """The MoE load-balance loss joins the cross-entropy with its weight."""
    ref, got = runs.loss(arch)
    assert ref[2] > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
