"""Checkpoints: save and restore {params, batch_stats, opt_state, epoch}.

Counterpart of `satmvs_tpu/train/checkpoints.py`, with `torch.save` in
place of Orbax: epoch k goes to `<directory>/<k>/state.pt`, written to a
temporary file and renamed, so a save cut short never looks committed and
resume (`epoch=None`) always finds a whole checkpoint.  Tensors are saved on
the CPU and restored onto the devices of the state they are copied into.
"""

from __future__ import annotations

import os
import tempfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import torch

_FILE = "state.pt"


def _snapshot(tree):
    """A CPU copy of a nest of dicts, lists, tensors and numbers."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    return tree


def _write(directory: str, epoch: int, snapshot: dict) -> None:
    path = os.path.join(os.path.abspath(directory), str(epoch))
    os.makedirs(path, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=path)
    os.close(fd)
    try:
        torch.save(snapshot, tmp)
        os.replace(tmp, os.path.join(path, _FILE))
    except BaseException:
        os.unlink(tmp)
        raise


def save_checkpoint(directory: str, epoch: int, state) -> None:
    """Save a `loop.TrainState` as epoch `epoch` (blocking)."""
    _write(directory, epoch, _snapshot(state.to_dict()))


class CheckpointKeeper:
    """Epoch saves for a training run: `save` copies the state to the CPU at
    once (training goes on mutating it) and writes the file in a worker
    thread, so training overlaps the write; `close` waits for every write
    and raises the first error."""

    def __init__(self, directory: str):
        self._directory = directory
        self._pool = ThreadPoolExecutor(1)
        self._pending: list[Future] = []

    def save(self, epoch: int, state) -> None:
        self._pending.append(
            self._pool.submit(_write, self._directory, epoch, _snapshot(state.to_dict())))

    def close(self) -> None:
        try:
            for f in self._pending:
                f.result()
        finally:
            self._pool.shutdown()


def latest_epoch(directory: str) -> Optional[int]:
    """The largest epoch with a committed checkpoint, or None."""
    if not os.path.isdir(directory):
        return None
    epochs = [int(e) for e in os.listdir(directory)
              if e.isdigit() and os.path.isfile(os.path.join(directory, e, _FILE))]
    return max(epochs, default=None)


def restore_checkpoint(directory: str, state, epoch: Optional[int] = None):
    """Copy a saved checkpoint into `state` (a `loop.TrainState`, in place);
    `epoch=None` takes the latest (resume).  Returns (state, epoch), or
    (None, None) when nothing is saved."""
    step = latest_epoch(directory) if epoch is None else epoch
    if step is None:
        return None, None
    saved = torch.load(os.path.join(directory, str(step), _FILE), map_location="cpu",
                       weights_only=True)
    state.load_dict(saved)
    return state, step
