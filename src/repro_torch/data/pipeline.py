"""Checkpointable input pipeline.

``DataIterator`` is a pure function of ``(seed, step)``: its checkpoint
state is two integers, so a restarted job replays exactly the batches it
has not consumed.  :func:`token_iterator` gives the language models'
synthetic token batches on the host (numpy, the reference's values);
:func:`jpeg_iterator` synthesises pixels on the host
(numpy, the same images as the reference package) and JPEG-encodes them
on the device through ``dispatch.block_dct`` — the block-DCT kernel on a
CUDA device.  :func:`jpeg_file_iterator` serves real JPEG files
(:func:`list_jpeg_files`) through the host codec with the same pure
``(seed, step)`` batches.  :func:`prefetch` overlaps batch production with
the step in a background thread that it joins on close.
"""
from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import dispatch as dispatchlib
from repro_torch.core import jpeg as jpeglib
from repro_torch.data import synthetic

__all__ = ["DataIterator", "token_iterator", "image_iterator",
           "jpeg_iterator",
           "list_jpeg_files", "jpeg_file_iterator", "prefetch"]


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


def token_iterator(seed: int, batch: int, seq_len: int,
                   vocab: int) -> DataIterator:
    """Host batches ``{"tokens": (B, S), "labels": (B, S)}`` int32 (numpy):
    one ``(B, S + 1)`` draw of :func:`synthetic.token_batch`, the labels
    the tokens shifted by one."""
    def fn(s, i):
        toks = synthetic.token_batch(s, i, batch, seq_len, vocab)["tokens"]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return DataIterator(fn, seed)


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


def list_jpeg_files(directory: str) -> list[str]:
    """Sorted JPEG paths under ``directory`` (recursive): sorted, so the
    list, and with it every ``(seed, step)`` batch, is reproducible."""
    out = []
    for root, _, names in os.walk(directory):
        for name in names:
            if name.lower().endswith((".jpg", ".jpeg", ".jfif")):
                out.append(os.path.join(root, name))
    return sorted(out)


def jpeg_file_iterator(paths: Sequence[str] | str, batch: int, *,
                       grid: tuple[int, int], channels: int = 3,
                       quality: int = 50, seed: int = 0,
                       label_fn: Callable[[str], int] | None = None,
                       pack_width: int | None = None) -> DataIterator:
    """Real JPEG files → canonical network coefficients, checkpointably.

    ``paths`` is a directory (walked once, sorted) or a sequence; each
    batch samples ``batch`` files with the same pure ``(seed, step)``
    rule as the synthetic iterators.  Files go through the host codec
    (entropy decode, quantization normalization, ``grid`` fit), so the
    batch is numpy on the host, as ``codec.ingest_batch`` returns it:
    ``{"coefficients": (B, bh, bw, C, 64)`` (or tile-packed ``(B, bh, bw,
    C·pack_width)``) ``float32, "labels": (B,) int32}``; ``label_fn`` maps
    a path to its class (default −1: unlabelled serving traffic).
    """
    from repro_torch.codec import ingest as ingestlib

    if isinstance(paths, str):
        paths = list_jpeg_files(paths)
    paths = list(paths)
    if not paths:
        raise ValueError("jpeg_file_iterator: no files")

    def fn(s, i):
        idx = synthetic._rng(s, i).integers(0, len(paths), size=batch)
        datas = []
        for j in idx:
            with open(paths[j], "rb") as f:
                datas.append(f.read())
        coef, _ = ingestlib.ingest_batch(
            datas, quality=quality, grid=grid, channels=channels,
            pack_width=pack_width, with_stats=False)
        labels = np.asarray([label_fn(paths[j]) if label_fn else -1
                             for j in idx], np.int32)
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
