"""The model mesh with more of the architectures whose mixers are all
GQA (split from ``test_torch_model_mesh.py`` so no file runs long under
``--dist loadfile``; Gemma-3 in ``test_torch_model_mesh_gemma.py``):
qwen2-72b and the embeddings-input stubs of InternVL2 and MusicGen (an
untied head split over the vocab), each one SGD step on a 2 × 2 mesh
against the reference's one-device step at f32 compute, to ``LOSS_RTOL``
and ``GRAD_RTOL``."""

import pytest

import _torch_model_mesh as mm


@pytest.mark.parametrize("arch", ["qwen2-72b", "internvl2-76b", "musicgen-large"])
def test_more_gqa_archs_on_a_model_mesh_match_the_reference(arch):
    mm.check_against_the_reference(arch, 2, 2, 1)
