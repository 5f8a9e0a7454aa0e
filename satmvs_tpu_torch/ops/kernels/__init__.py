"""Hand-written CUDA kernels (csrc/) with their wrappers and plain versions.

No module here imports a compiler or builds anything when it is imported:
kernels are compiled at first launch (`build.load`).
"""

from __future__ import annotations

import torch


def refuse_graph(name: str, backward: str, *tensors) -> None:
    """Raise before a CUDA kernel that has no backward would cut an autograd
    graph: when gradients are being recorded and any input (None skipped)
    requires one.  `backward` says where the backward kernel comes from.  The
    plain versions, taken for CPU tensors, stay differentiable."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward yet, so autograd "
                           f"cannot differentiate through it ({backward}); call it under "
                           f"torch.no_grad()")
