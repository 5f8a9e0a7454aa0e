"""Metric logging: a JSONL stream always, TensorBoard when tensorboardX is
installed.  Counterpart of `satmvs_tpu/train/logging.py`; `metrics.jsonl` is
the machine-readable record."""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, workdir: str):
        os.makedirs(workdir, exist_ok=True)
        self._jsonl = open(os.path.join(workdir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(workdir)

    def scalars(self, mode: str, scalar_dict: dict, step: int) -> None:
        rec = {"mode": mode, "step": step, "time": time.time(), **scalar_dict}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalar_dict.items():
                self._tb.add_scalar(f"{mode}/{k}", v, step)

    def image(self, mode: str, name: str, img, step: int) -> None:
        """An (H, W) or (C, H, W) numpy image, min-max scaled (TensorBoard only)."""
        if self._tb is not None:
            arr = img[None] if img.ndim == 2 else img
            lo, hi = arr.min(), arr.max()
            self._tb.add_image(f"{mode}/{name}", (arr - lo) / (hi - lo + 1e-9), step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
