"""Gemma-3 on the model mesh (its own file: the reference's init and jit
of its 6-layer period take most of this file's time under ``--dist
loadfile``): QK-norm weights fanned out to the model positions, sandwich
norms, sliding-window and global layers, the tied table resharded to
vocab over ``model``; one SGD step on a 2 × 2 mesh against the
reference's one-device step at f32 compute, to ``LOSS_RTOL`` and
``GRAD_RTOL``."""

import _torch_model_mesh as mm


def test_gemma3_on_a_model_mesh_matches_the_reference():
    mm.check_against_the_reference("gemma3-4b", 2, 2, 1)
