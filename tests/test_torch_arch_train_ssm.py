"""``tests/test_arch_smoke.py::test_train_step`` on the port for the
recurrent (RWKV-6, Mamba) architectures at ``scaled_down()``: one AdamW step of
``repro_torch.train.make_train_step`` from the reference's converted
weights, finite, counted, params moved, and its loss and ``grad_norm``
held to the reference's jitted step at f32 compute (loss within 1e-5,
``grad_norm`` within 1e-4, relative). Split from the other archs so no
file runs long under ``--dist loadfile``."""

import pytest

from repro_torch.train import checkpoint

import _torch_train as tt

ARCHS = ('rwkv6-3b', 'jamba-v0.1-52b')


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step(arch):
    ref_model, model, jp, p = tt.models(arch)
    host = tt.batch(model.cfg)
    (_, jm), (state2, pm) = tt.steps(ref_model, model, jp, p, host, "adamw", lr=1e-3)
    tt.assert_metrics_close(jm, pm)
    assert int(state2.opt.step) == 1
    moved = any(bool((a != b).any()) for a, b in zip(checkpoint.leaves(p),
                                                     checkpoint.leaves(state2.params))
                if a.is_floating_point())
    assert moved
