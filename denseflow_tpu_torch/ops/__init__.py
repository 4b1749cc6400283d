from denseflow_tpu_torch.ops.derivatives import (
    centered_gradient,
    divergence,
    forward_gradient,
)
from denseflow_tpu_torch.ops.pyramid import build_pyramid, pyramid_shapes
from denseflow_tpu_torch.ops.resize import resize_bilinear

__all__ = [
    "centered_gradient",
    "divergence",
    "forward_gradient",
    "build_pyramid",
    "pyramid_shapes",
    "resize_bilinear",
]
