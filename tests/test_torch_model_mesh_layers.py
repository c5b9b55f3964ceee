"""The model mesh with the other layer kinds the model axis takes (split
from ``test_torch_model_mesh.py`` so no file runs long under ``--dist
loadfile``): GQA whose query and KV heads both split, qwen's q/k/v
biases, and the paper's MLP dense (output columns over ``model``) and
block-sparse (its weights whole, run once a group on the home device),
each one SGD step on a 2 × 2 mesh against the reference's one-device
step at f32 compute, to ``LOSS_RTOL`` and ``GRAD_RTOL``."""

import pytest

import _torch_model_mesh as mm
import _torch_train as tt


@pytest.mark.parametrize("arch,variant,data,model", [
    ("llama3.2-1b", "kv-split", 2, 2),  # query and KV heads both split
    ("qwen1.5-4b", None, 2, 2),  # b_q, b_k, b_v over model
    (mm.DENSE_MLP_ID, None, 2, 2),  # the paper's MLP: output columns over model
    (tt.tm.SPARSE_MLP_ID, None, 2, 2),  # block-sparse weights whole, once a group
])
def test_other_layers_on_a_model_mesh_match_the_reference(arch, variant, data, model):
    mm.check_against_the_reference(arch, data, model, 1, variant)
