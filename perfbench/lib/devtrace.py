"""The traced window: ``torch.profiler`` around the measured window, reduced
to the device's busy time, its idle gaps, and its operations by name.

Timestamps are the profiler's (wall-clock nanoseconds); :func:`wall_ns`
maps a ``time.monotonic()`` reading onto that clock, so the program's own
spans can be laid beside the kernels.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


def wall_ns(monotonic_s: float, anchor: tuple[float, int]) -> int:
    """``monotonic_s`` on the wall clock, given one ``(time.monotonic(),
    time.time_ns())`` pair read together."""
    return anchor[1] + int(round((monotonic_s - anchor[0]) * 1e9))


def anchor() -> tuple[float, int]:
    return time.monotonic(), time.time_ns()


@dataclass
class Trace:
    """What one traced window holds: device operations and host operations
    as ``(name, start_ns, end_ns)``, and the window's bounds."""

    t0_ns: int = 0
    t1_ns: int = 0
    device_ops: list = field(default_factory=list)
    host_ops: list = field(default_factory=list)
    enabled: bool = False

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window, in order."""
        ivs = sorted((max(a, self.t0_ns), min(b, self.t1_ns))
                     for _, a, b in self.device_ops)
        out: list[list[int]] = []
        for a, b in ivs:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> list[tuple[int, int]]:
        """The intervals of the window in which nothing ran on the device."""
        gaps, t = [], self.t0_ns
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1_ns > t:
            gaps.append((t, self.t1_ns))
        return gaps

    def device_seconds_by_name(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, a, b in self.device_ops:
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
        return out

    def breakdown(self, host_spans=(), top: int = 10) -> dict:
        """The device operations that took the most time, and the longest
        idle gaps, each named by the host operation or span that covered
        most of it (``host_spans``: extra ``(name, start_ns, end_ns)``)."""
        ops = sorted(self.device_seconds_by_name().items(),
                     key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        hosts = list(self.host_ops) + list(host_spans)
        named = []
        for a, b in gaps:
            best, cover = "no host operation", 0
            for name, ha, hb in hosts:
                c = min(b, hb) - max(a, ha)
                if c > cover:
                    best, cover = name, c
            named.append([best, (b - a) / 1e9])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


@contextlib.contextmanager
def window(enabled: bool, device):
    """Profile the ``with`` block when ``enabled`` (CPU and CUDA
    activity); yields a :class:`Trace`, filled in on exit after a device
    synchronise."""
    import torch

    tr = Trace(enabled=enabled)
    if not enabled:
        tr.t0_ns = time.time_ns()
        yield tr
        tr.t1_ns = time.time_ns()
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    tr.t0_ns = time.time_ns()
    try:
        yield tr
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tr.t1_ns = time.time_ns()
        prof.stop()
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        rec = (e.name(), a, a + e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            tr.device_ops.append(rec)
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            tr.host_ops.append(rec)
