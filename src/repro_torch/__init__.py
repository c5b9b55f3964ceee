"""PyTorch + CUDA port of the sparse DNN and its GraphBLAS for NVIDIA Hopper.

A second package beside ``repro`` (the JAX/Pallas reference, which this
package never imports). It mirrors the reference's layout module for
module — ``repro_torch/sparse/bsr.py`` answers to ``repro/sparse/bsr.py``
— and ports two paths:

    serve.challenge.run_challenge → serve.engine.SparseDNNEngine
      → plan.degrade.DegradationLadder → plan.cache.PlanCache
      → plan.stack_plan.StackPlan → kernels.ops wrappers
      → the hand-written CUDA C++ kernels in ``csrc/``

    core.graphblas (mxm / mxv / vxm over the eight semirings of
      core.semiring) → plan.mxm.MxmPlan → kernels.ops wrappers
      → the same kernels, templated on csrc/semiring.cuh

Entry points run on ``cuda`` unless the caller passes ``device=``; with
no GPU and no explicit device they raise instead of falling back to the
CPU. On CPU tensors every kernel wrapper runs its plain PyTorch version.
"""

from repro_torch.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
