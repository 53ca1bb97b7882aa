"""Checkpointable input pipeline.

``DataIterator`` is a pure function of ``(seed, step)``: its checkpoint
state is two integers, so a restarted job replays exactly the batches it
has not consumed.  :func:`jpeg_iterator` synthesises pixels on the host
(numpy, the same images as the reference package) and JPEG-encodes them
on the device through ``dispatch.block_dct`` — the block-DCT kernel on a
CUDA device.  :func:`prefetch` overlaps batch production with the step in
a background thread that it joins on close.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import dispatch as dispatchlib
from repro_torch.core import jpeg as jpeglib
from repro_torch.data import synthetic

__all__ = ["DataIterator", "image_iterator", "jpeg_iterator", "prefetch"]


@dataclass
class DataIterator:
    """Stateful wrapper over a pure ``(seed, index) -> batch`` function."""

    fn: Callable[[int, int], dict[str, Any]]
    seed: int
    step: int = 0

    def __iter__(self) -> "DataIterator":
        return self

    def __next__(self) -> dict[str, Any]:
        batch = self.fn(self.seed, self.step)
        self.step += 1
        return batch

    def state_dict(self) -> dict[str, int]:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, state: dict[str, int]) -> None:
        self.seed = int(state["seed"])
        self.step = int(state["step"])


def image_iterator(seed: int, batch: int, size: int, channels: int = 3,
                   num_classes: int = 10) -> DataIterator:
    """Host batches ``{"images": (B, C, H, W) f32, "labels": (B,) i32}``
    (numpy)."""
    def fn(s, i):
        return synthetic.image_batch(s, i, batch, size, channels, num_classes)
    return DataIterator(fn, seed)


def jpeg_iterator(seed: int, batch: int, size: int, channels: int = 3,
                  num_classes: int = 10, quality: int = 50,
                  lossy: bool = False, *,
                  device: str | torch.device | None = None,
                  dispatch: dispatchlib.DispatchConfig | None = None
                  ) -> DataIterator:
    """Batches ``{"coefficients": (B, bh, bw, C, 64), "labels": (B,)
    int64}`` on ``device``: step-4 JPEG coefficients divided by the
    quality's table, encoded on the device.  ``lossy=True`` applies
    step-5 rounding (the real-data regime)."""
    dev = resolve_device(device)

    def fn(s, i):
        b = synthetic.image_batch(s, i, batch, size, channels, num_classes)
        img = torch.as_tensor(b["images"]).to(dev)
        coef = dispatchlib.block_dct(jpeglib.block_channels_last(img),
                                     quality, dispatch)
        if lossy:
            coef = torch.round(coef)
        labels = torch.as_tensor(b["labels"].astype(np.int64)).to(dev)
        return {"coefficients": coef, "labels": labels}

    return DataIterator(fn, seed)


def prefetch(it: Iterator[Any], depth: int = 2) -> Iterator[Any]:
    """Background-thread prefetch.

    The producer thread is owned by the generator: closing it early
    (``close()``, ``break``, an exception in the consumer) or exhausting
    it joins the thread and drains the queue.  An exception in the source
    iterator is raised at the consumer's next pull.
    """
    q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
            put(sentinel)
        except BaseException as e:  # re-raised on the consumer side
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while t.is_alive():
            try:  # unblock a producer stuck on a full queue
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)
