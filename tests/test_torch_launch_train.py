"""The training launcher (``python -m repro_torch.launch.train``) on the
CPU at ``--scale-down``: the reference's driver loop (chunks of 10 steps,
a checkpoint at each chunk's end, ``[train]`` lines), a resume from the
step-10 checkpoint that replays the uninterrupted run's metrics bit for
bit, microbatching, and the refusals (no card without ``--device``, the
production mesh)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.launch import train as launch_train

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
