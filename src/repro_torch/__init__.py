"""PyTorch + CUDA port of the sparse-DNN serving path for NVIDIA Hopper.

A second package beside ``repro`` (the JAX/Pallas reference, which this
package never imports). It mirrors the reference's layout module for
module — ``repro_torch/sparse/bsr.py`` answers to ``repro/sparse/bsr.py``
— and ports the GraphChallenge serving path:

    serve.challenge.run_challenge → serve.engine.SparseDNNEngine
      → plan.degrade.DegradationLadder → plan.cache.PlanCache
      → plan.stack_plan.StackPlan → kernels.ops wrappers
      → the hand-written CUDA C++ kernels in ``csrc/``

Entry points run on ``cuda`` unless the caller passes ``device=``; with
no GPU and no explicit device they raise instead of falling back to the
CPU. On CPU tensors every kernel wrapper runs its plain PyTorch version.
"""

from repro_torch.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
