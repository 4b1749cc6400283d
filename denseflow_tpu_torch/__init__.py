"""denseflow_tpu_torch — the PyTorch + CUDA port of denseflow_tpu.

The JAX package `denseflow_tpu` stays the reference. This package runs its
flow paths on an NVIDIA GPU: cv2 decode and resize, pair batching on the
device, TVL1 / nv, Farneback or Brox pyramids whose per-level solves are
hand-written CUDA kernels (csrc/), CAST quantization on the device, and jpg
emission with the reference's naming grammar and `.done` resume. It imports
neither jax nor denseflow_tpu.
"""

__version__ = "0.1.0"

from denseflow_tpu_torch.config import FlowConfig  # noqa: F401
