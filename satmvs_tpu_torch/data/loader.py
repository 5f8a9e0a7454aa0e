"""Batching with shuffling, threaded prefetch and the move to the device.

Counterpart of `satmvs_tpu/data/loader.py`.  A worker thread reads and
collates the samples of the next batches while the consumer computes; an
exception in the worker is raised again on the consumer.  Each batch
reaches the consumer on its device (the GPU unless the caller asks for the
CPU) in the layout `train.loop` and `CascadeModel.forward` take, the
layout of `synthetic.make_batch`:

  imgs (B, V, H, W, 3), cams (per-stage batched RpcWarpCams or
  QcWarpCams, or pinhole (B, V, 4, 4) projection matrices),
  depth_values (B, 2), depth_stages / mask_stages (per stage (B, h, w);
  not in pred mode), out_view / out_name (lists of strings, on the host).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..ops import warp as warplib

_ROUTING = ("out_view", "out_name")


def collate(samples: list[dict]) -> dict:
    """Stack dataset samples into one batch of CPU tensors (strings in lists)."""
    out = {
        "imgs": torch.from_numpy(np.stack([s["imgs"] for s in samples])),
        "cams": tuple(warplib.stack_cams([s["cams"][i] for s in samples])
                      for i in range(len(samples[0]["cams"]))),
        "depth_values": torch.from_numpy(np.stack([s["depth_values"] for s in samples])),
        "out_view": [s["out_view"] for s in samples],
        "out_name": [s["out_name"] for s in samples],
    }
    if "depth_stages" in samples[0]:
        for key in ("depth_stages", "mask_stages"):
            out[key] = [torch.from_numpy(np.stack([s[key][i] for s in samples]))
                        for i in range(len(samples[0][key]))]
    return out


def _map_tensors(batch: dict, fn) -> dict:
    """The batch with fn applied to every tensor; routing strings kept."""
    out = {}
    for k, v in batch.items():
        if k in _ROUTING:
            out[k] = v
        elif k == "cams":
            out[k] = tuple(fn(c) if isinstance(c, torch.Tensor) else c.map(fn) for c in v)
        elif isinstance(v, list):
            out[k] = [fn(t) for t in v]
        else:
            out[k] = fn(v)
    return out


def to_device(batch: dict, device) -> dict:
    """The batch's tensors on `device`; from pinned memory the copies do not
    block the host.  Routing strings stay on the host."""
    dev = torch.device(device)
    return _map_tensors(batch, lambda t: t.to(dev, non_blocking=True))


PREFETCH = 2  # batches the worker reads ahead of the consumer


def _timing() -> dict:
    return {"batches": 0, "read_s": 0.0, "collate_s": 0.0, "pin_s": 0.0, "wait_s": 0.0}


class Loader:
    """Batches of a dataset in order or shuffled (from `seed`), prefetched
    PREFETCH batches ahead by one worker thread and moved to `device` (the
    GPU unless "cpu" is passed).

    `timing` holds, for the latest pass: batches; the worker's seconds
    reading samples (read_s), collating them (collate_s) and pinning them
    (pin_s); and wait_s, the consumer's seconds waiting for a batch, so a
    run can tell whether loading keeps up.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, seed: int = 0,
                 device=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self.timing = _timing()

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _batches(self, timing: dict) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        pin = self.device.type == "cuda"
        for i in range(len(self)):
            t0 = time.perf_counter()
            idxs = order[i * self.batch_size:(i + 1) * self.batch_size]
            samples = [self.dataset[int(j)] for j in idxs]
            t1 = time.perf_counter()
            batch = collate(samples)
            t2 = time.perf_counter()
            if pin:  # page-locked, so the copy to the card does not block the host
                batch = _map_tensors(batch, lambda t: t.pin_memory())
            t3 = time.perf_counter()
            timing["read_s"] += t1 - t0
            timing["collate_s"] += t2 - t1
            timing["pin_s"] += t3 - t2
            yield batch

    def __iter__(self) -> Iterator[dict]:
        timing = self.timing = _timing()
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        done = object()
        stop = threading.Event()
        error: list[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for b in self._batches(timing):
                    if not put(b):
                        return
            except BaseException as exc:  # raised again on the consumer
                error.append(exc)
            put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                timing["wait_s"] += time.perf_counter() - t0
                if item is done:
                    if error:
                        raise error[0]
                    return
                timing["batches"] += 1
                yield to_device(item, self.device)
        finally:
            # a consumer that stops early (or fails) releases the worker
            stop.set()
            t.join()
