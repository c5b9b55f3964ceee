"""``test_torch_models.py``'s comparisons for Gemma-3: sliding-window
local layers (ring-buffer caches), QK-norm, sandwich norms, GeGLU and
tied embeddings."""

import numpy as np
import pytest

import _torch_models as tm

ARCHS = ("gemma3-4b",)


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
