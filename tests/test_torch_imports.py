"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports JAX or anything of the JAX package ``repro``."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:[.\s]|$)", re.M)

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
assert "triton" not in sys.modules
print(len(names), "modules", *names)
"""
# modules each slice added, which the walk above must reach
SLICE_MODULES = ("repro_torch.tune.table", "repro_torch.tune.sweep",
                 "repro_torch.train.checkpoint", "repro_torch.train.fault_tolerance",
                 "repro_torch.train.resilience", "repro_torch.launch.mesh",
                 "repro_torch.distribution.sharding", "repro_torch.sparse.partition",
                 "repro_torch.plan.sharded", "repro_torch.serve.loadgen",
                 "repro_torch.serve.fleet", "repro_torch.serve.frontend")


def test_every_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[0]) >= 20, r.stdout
    assert set(SLICE_MODULES) <= set(r.stdout.split()[2:]), r.stdout


def test_sources_never_import_jax_or_the_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if FORBIDDEN.search(f.read_text())]
    assert not offenders, offenders


def test_every_kernel_has_a_cuda_source():
    from repro_torch.kernels import build

    for name in build.SOURCES:
        src = build.CSRC_DIR / f"{name}.cu"
        text = src.read_text()
        assert "cuda_error_string" in text and "cudaGetLastError" in text, name
        assert build.library_path(name).name.startswith(f"lib{name}-")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
