"""satmvs-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

The module layout mirrors the JAX package `satmvs_tpu`, so each counterpart
is easy to find.  Public functions keep the JAX layouts: features (H, W, C),
volumes (D, H, W, C), images (B, V, H, W, 3).  Entry points (the model
builder, the synthetic batch builder and `infer.scene.predict_scene`) run
on the GPU unless the caller passes ``device="cpu"``; see
`device.resolve_device`.

This package imports torch and numpy only, never JAX or `satmvs_tpu`.
"""

from .device import resolve_device  # noqa: F401
