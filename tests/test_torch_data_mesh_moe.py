"""The data mesh with a MoE arch (split from ``test_torch_data_mesh.py``
so no file runs long under ``--dist loadfile``): a 4-position step of
``moonshot-v1-16b-a3b`` against the reference's one-device step, each
position given 256 tokens so its MoE token groups are the reference's,
and the refusal of a batch that does not split into its microbatches (a
split whose token groups cross positions: ``test_torch_moe_data_train.py``)."""

import pytest

from repro_torch.distribution import sharding as sh
from repro_torch.train import checkpoint, make_train_step, sgd
from repro_torch.train.trainer import TrainState, state_shardings

import _torch_mesh as tm
import _torch_train as tt
from _torch_mesh import MOE_ARCH, four_positions


def test_a_4_position_moe_step_matches_the_reference_one_device_step():
    tm.check_against_the_reference(MOE_ARCH, 1)


def test_a_batch_that_does_not_split_into_its_microbatches_is_refused():
    """A batch of 6 rows over 4 positions is refused with the mesh path's
    message (a split whose token groups cross positions runs:
    ``test_torch_moe_data_train.py``)."""
    _, model, _, p = tt.models(MOE_ARCH)
    state = TrainState(p, sgd(1e-2).init(checkpoint.leaves(p)))
    placed = sh.place(state, state_shardings(None, state, four_positions()))
    with pytest.raises(ValueError, match="does not split into 1 microbatches of 4"):
        make_train_step(model, sgd(1e-2))(placed, tt.as_port(tt.batch(model.cfg, b=6, s=16)))
