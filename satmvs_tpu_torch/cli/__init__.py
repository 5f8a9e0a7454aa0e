"""Command-line twins of the JAX package's scripts: `train` (scripts/train.py),
`predict` (scripts/predict.py), `predict_scene` (scripts/predict_scene.py)
and `convert_ckpt` (scripts/convert_ckpt.py, on the CPU), each
`main(argv=None)` and runnable as `python -m satmvs_tpu_torch.cli.<name>`
with the same flags and defaults.  They run on the GPU; SATMVS_PLATFORM=cpu
puts them on the CPU (the JAX scripts' switch), and without a GPU they
raise rather than continue on the CPU.  Launched by `python -m
torch.distributed.run --nproc_per_node N`, each rank runs on its own card
(cuda:{LOCAL_RANK}) and `train` trains data-parallel (--mesh_data N),
`predict_scene` predicts tile-parallel."""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..dist import init_multihost


def cli_device(deterministic: bool = False) -> torch.device:
    """The device a CLI runs on: SATMVS_PLATFORM=cpu → the CPU; unset, "gpu"
    or "cuda" → the GPU (raises without one; under torchrun the rank's own
    card), with its convolutions and
    matmuls in fp32 (PyTorch lets cuDNN's convolutions take TF32 by default,
    ~1e-3 relative off the fp32 features the port is held to) and, with
    `deterministic`, on cuDNN's deterministic engines: FeatureNet's default
    engines give maps that differ run to run by ~6e-4 m; the deterministic
    ones cost a 384×768 forward 0.3-0.5 % on an H100."""
    platform = os.environ.get("SATMVS_PLATFORM", "").lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "gpu", "cuda"):
        raise ValueError(f"SATMVS_PLATFORM={platform!r}: the port runs on 'cpu' or 'gpu'")
    device = resolve_device(None)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic
    return device


@contextlib.contextmanager
def process_group(device):
    """torchrun's process group for the length of a CLI run: joined on
    `device` (nccl on a card, gloo on the CPU) when torchrun launched the
    CLI (WORLD_SIZE set) and left at the end.  Yields the world size: 1
    without torchrun, or the size of a group the caller joined before."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        yield dist.get_world_size() if dist.is_initialized() else 1
        return
    world = init_multihost(device=device)
    try:
        yield world
    finally:
        dist.destroy_process_group()


def restore_model(cfg, directory: str, device):
    """The configured model on `device` with the latest port checkpoint
    under `directory` (`train.checkpoints`, <directory>/<epoch>/state.pt)
    copied in.  Returns (model, state, epoch); raises SystemExit when no
    checkpoint is there."""
    from ..train.checkpoints import restore_checkpoint
    from ..train.loop import create_model, make_optimizer, state_of

    model = create_model(cfg, device)
    restored, epoch = restore_checkpoint(directory, state_of(model, make_optimizer(cfg, 1)))
    if restored is None:
        raise SystemExit(f"no checkpoint found under {directory}")
    print(f"loaded checkpoint epoch {epoch}")
    return model, restored, epoch
