"""Command-line twins of the JAX package's scripts: `train` (scripts/train.py),
`predict` (scripts/predict.py) and `predict_scene` (scripts/predict_scene.py),
each `main(argv=None)` and runnable as `python -m satmvs_tpu_torch.cli.<name>`
with the same flags and defaults.  They run on the GPU; SATMVS_PLATFORM=cpu
puts them on the CPU (the JAX scripts' switch), and without a GPU they
raise rather than continue on the CPU."""

from __future__ import annotations

import os

import torch

from ..device import resolve_device


def cli_device(deterministic: bool = False) -> torch.device:
    """The device a CLI runs on: SATMVS_PLATFORM=cpu → the CPU; unset, "gpu"
    or "cuda" → the GPU (raises without one), with its convolutions and
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


def restore_model(cfg, directory: str, device):
    """The configured model on `device` with the latest port checkpoint
    under `directory` (`train.checkpoints`, <directory>/<epoch>/state.pt)
    copied in.  Returns (model, state, epoch); raises SystemExit when no
    checkpoint is there."""
    from ..train.checkpoints import restore_checkpoint
    from ..train.loop import create_model_and_state

    model, state, _ = create_model_and_state(cfg, {"imgs": torch.empty(0, device=device)}, 1)
    restored, epoch = restore_checkpoint(directory, state)
    if restored is None:
        raise SystemExit(f"no checkpoint found under {directory}")
    print(f"loaded checkpoint epoch {epoch}")
    return model, restored, epoch
