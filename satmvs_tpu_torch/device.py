"""Default-device resolution for the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point puts its tensors on.

    None means the GPU: under torchrun (LOCAL_RANK set) the rank's own card,
    cuda:{LOCAL_RANK}, else the current one.  Without a GPU, or with a
    LOCAL_RANK beyond the visible cards, this raises instead of continuing
    elsewhere: the CPU is used only when the caller asks for it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if "LOCAL_RANK" not in os.environ:
            return torch.device("cuda")
        local = int(os.environ["LOCAL_RANK"])
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} but {torch.cuda.device_count()} CUDA "
                               "devices are visible")
        return torch.device("cuda", local)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev
