"""denseflow_tpu_torch — the PyTorch + CUDA port of denseflow_tpu.

The JAX package `denseflow_tpu` stays the reference. This package runs its
main path on an NVIDIA GPU: cv2 decode and resize, pair batching on the
device, a 5-level TVL1 pyramid whose per-scale solve is a hand-written CUDA
kernel (csrc/tvl1_scale.cu), CAST quantization on the device, and jpg
emission with the reference's naming grammar and `.done` resume. It imports
neither jax nor denseflow_tpu.
"""

__version__ = "0.1.0"

from denseflow_tpu_torch.config import FlowConfig  # noqa: F401
