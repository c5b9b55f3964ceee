import os

# Tests must see the real single-CPU device (the 512-device override is
# dryrun.py-only). Force a deterministic, quiet JAX.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_default_matmul_precision", "highest")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running tests — GraphChallenge-scale conformance "
        "configs (interpret-mode kernels on 120-layer / 16384-neuron "
        "stacks) and multi-device subprocess runs. Tier-1 CI deselects "
        "them (-m 'not slow') and a dedicated slow job runs them; the "
        "multi-device job also deselects them because it runs the same "
        "sharded checks in-process on its 8-device view",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA kernels); "
        "skips with a reason on a host without one",
    )

# Property tests prefer real hypothesis (requirements-dev.txt); in
# hermetic containers without it, install the deterministic fallback shim
# so the same test modules still collect and run.
try:
    import hypothesis  # noqa: F401
except ImportError:
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_fallback

    _hypothesis_fallback.install()
