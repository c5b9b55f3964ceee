"""The training launcher (``python -m repro_torch.launch.train``) on the
CPU at ``--scale-down``: the reference's driver loop (chunks of 10 steps,
a checkpoint at each chunk's end, ``[train]`` lines), a resume from the
step-10 checkpoint that replays the uninterrupted run's metrics bit for
bit, microbatching, and the refusals (no card without ``--device``, the
production mesh). Over 4 positions of the data mesh (``--data 4``, at f32
compute) the losses are the one-position run's within ``LOSS_RTOL``, and
a resumed run replays them bit for bit."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train

LOSS_RTOL = 1e-5  # f32 compute, as tests/_torch_train.py

ARGS = ["--arch", "llama3.2-1b", "--scale-down", "--device", "cpu", "--steps", "20",
        "--seq-len", "32", "--global-batch", "4"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt"))
    return d, launch_train.main(ARGS + ["--ckpt-dir", d])


def test_runs_twenty_steps_with_a_checkpoint_at_each_chunk_end(run):
    d, hist = run
    assert [h["step"] for h in hist] == list(range(1, 21))
    assert all(np.isfinite([h["loss"], h["grad_norm"], h["ce"]]).all() for h in hist)
    assert sorted(os.listdir(d)) == ["step_00000010", "step_00000020"]
    with open(os.path.join(d, "step_00000020", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["arch"] == "llama3.2-1b-smoke" and manifest["supervised"]
    assert "opt//mu//embed" in manifest["keys"] and "opt//step" in manifest["keys"]


def test_resume_from_step_ten_replays_the_losses_bit_for_bit(run, tmp_path, capsys):
    d, hist = run
    resumed_dir = str(tmp_path / "ckpt")
    shutil.copytree(d, resumed_dir)
    shutil.rmtree(os.path.join(resumed_dir, "step_00000020"))  # as if stopped at 10
    again = launch_train.main(ARGS + ["--ckpt-dir", resumed_dir, "--resume"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 10" in out and "[train] step    20" in out
    assert [h["step"] for h in again] == list(range(11, 21))
    assert again == hist[10:]


def test_microbatched_run_and_lines(tmp_path, capsys):
    hist = launch_train.main(["--arch", "llama3.2-1b", "--scale-down", "--device", "cpu",
                              "--steps", "3", "--seq-len", "16", "--global-batch", "4",
                              "--microbatches", "2", "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[train] arch=llama3.2-1b-smoke mesh={'data': 1, 'model': 1}")
    assert lines[1].startswith("[train] step     3 loss=") and lines[-1] == "[train] done"
    assert len(hist) == 3 and np.isfinite(hist[-1]["loss"])


def test_refusals(tmp_path):
    with pytest.raises(ValueError, match="production mesh"):
        launch_train.main(ARGS + ["--ckpt-dir", str(tmp_path), "--production-mesh"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_train.main(["--arch", "llama3.2-1b", "--scale-down"])


@pytest.fixture(scope="module")
def f32_runs(tmp_path_factory):
    """The same 20 steps at f32 compute on one position and on 4 positions
    of the CPU (bf16 compute rounds a row's products by the rows beside
    it, and AdamW carries that ~1e-5 a step)."""
    d = str(tmp_path_factory.mktemp("f32"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(launch_train, "get_config",
                   lambda arch: dataclasses.replace(get_config(arch), compute_dtype="float32"))
        one = launch_train.main(ARGS + ["--ckpt-dir", os.path.join(d, "one")])
        four = launch_train.main(ARGS + ["--ckpt-dir", os.path.join(d, "four"), "--data", "4"])
        yield d, one, four


def test_the_launcher_over_4_positions_gives_the_one_position_losses(f32_runs):
    _, one, four = f32_runs
    assert [h["step"] for h in four] == list(range(1, 21))
    for a, b in zip(one, four):
        assert abs(a["loss"] - b["loss"]) <= LOSS_RTOL * abs(a["loss"]), (a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-4 * a["grad_norm"], (a, b)


def test_a_4_position_resume_replays_the_losses_bit_for_bit(f32_runs, tmp_path, capsys):
    d, _, four = f32_runs
    resumed_dir = str(tmp_path / "ckpt")
    shutil.copytree(os.path.join(d, "four"), resumed_dir)
    shutil.rmtree(os.path.join(resumed_dir, "step_00000020"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(launch_train, "get_config",
                   lambda arch: dataclasses.replace(get_config(arch), compute_dtype="float32"))
        again = launch_train.main(ARGS + ["--ckpt-dir", resumed_dir, "--resume", "--data", "4"])
    out = capsys.readouterr().out
    assert "mesh={'data': 4, 'model': 1}" in out and "[train] resumed from step 10" in out
    assert again == four[10:]
