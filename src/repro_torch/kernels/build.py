"""Build the CUDA C++ kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so <name>.cu

The library name carries a hash of the source, of every header in
``csrc/`` and of the flags, so an edited source or header rebuilds and
an unchanged one is reused. The build runs at first use, into
``src/repro_torch/_build/`` (listed in ``.gitignore``); :func:`build`
compiles every missing library at once, one nvcc process per source,
and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("semiring_matmul", "bsr_spmm", "bcsr_spmm", "fused_mlp")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

_libraries: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the
    toolkit's default location, else ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in (home, "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from src/repro_torch/csrc at first use"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built. Every ``.cuh``
    beside it is hashed in too: a source's includes are not parsed, and a
    header edit must not reuse a library built from the old one."""
    h = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all
    nvcc processes at once. Returns each library's nvcc output (the
    ``-Xptxas -v`` register, shared-memory and spill report), kept
    beside a library built earlier; raises RuntimeError naming each
    source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    running = {}
    logs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            log = target.with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
            continue
        compiler = compiler or nvcc()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, target)
    failed = []
    try:
        for name, (proc, tmp, target) in running.items():
            logs[name], _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{logs[name]}")
            else:
                target.with_suffix(".log").write_text(logs[name])
                os.replace(tmp, target)
    finally:
        for proc, tmp, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each exported C function to its ``argtypes``;
    every function returns the ``cudaError_t`` of its launch as an int,
    and every library exports ``cuda_error_string`` to name it.
    """
    lib = _libraries.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _libraries[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch — too
    much shared memory, too many threads — never runs and is seen only
    here)."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")


def require(kernel: str, ok: bool, what: str) -> None:
    """Raise ValueError unless a launch precondition holds."""
    if not ok:
        raise ValueError(f"{kernel} CUDA kernel needs {what}")


def require_contiguous_on(device, kernel: str, *tensors) -> None:
    """Raise unless every tensor is contiguous and on ``device`` (the
    kernels index raw row-major pointers on one card)."""
    for t in tensors:
        if t.device != device or not t.is_contiguous():
            raise ValueError(
                f"{kernel} CUDA kernel needs contiguous tensors on {device}; "
                f"got a {tuple(t.shape)} tensor on {t.device} "
                f"(contiguous={t.is_contiguous()})"
            )


def require_aligned(kernel: str, *tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (the
    kernels copy rows with 16-byte ``cp.async``)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(
                f"{kernel} CUDA kernel needs 16-byte aligned tensors; got a "
                f"{tuple(t.shape)} tensor at offset {t.data_ptr() % 16}"
            )


def on_card(device):
    """The context a launch runs in: ``device``'s card made the CUDA
    runtime's current device. The ctypes launchers set a kernel's
    shared-memory limit and launch on the current device, so operands on
    another card need this guard (the stream alone names no device)."""
    import torch

    return torch.cuda.device(device)


def pointer(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for the launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
