"""Roofline math over pluggable hardware profiles.

A registry of :class:`HardwareProfile` peak numbers keyed by name
(the reference package's four entries, plus ``h100``), resolved from, in
priority order, an explicit spec (CLI flag), the ``JPEG_HW_PROFILE``
environment variable, a caller default, or the detected device.

A profile spec is either a registry name (``tpu-v5e``, ``cpu``, ...) or
a custom ``peak_flops,hbm_bw,link_bw`` triple of floats, e.g.
``JPEG_HW_PROFILE=1.97e14,8.19e11,5e10``.

:func:`roofline` turns an HLO cost (FLOPs / anchor bytes / collective
bytes, e.g. from ``introspect.opcount.count``) into the three
roofline terms and the dominant one — ``compute`` (FLOP-bound),
``memory`` (HBM-bound) or ``collective`` (interconnect-bound) — plus
the predicted latency (the max term: perfect overlap is assumed, so
this is a *lower bound* the measured wall is compared against).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from repro_torch.introspect.opcount import PEAK_BYTES, PEAK_FP32_FLOPS

__all__ = [
    "HardwareProfile",
    "PROFILES",
    "detect_backend",
    "resolve_profile",
    "roofline",
]


@dataclass(frozen=True)
class HardwareProfile:
    """Peak rates a roofline prediction divides by.

    ``peak_flops`` — peak dense f32/bf16 FLOP/s per device;
    ``hbm_bw`` — main-memory bandwidth, bytes/s;
    ``link_bw`` — per-device interconnect bandwidth, bytes/s.
    """

    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float

    def to_json(self) -> dict:
        return {"name": self.name, "peak_flops": self.peak_flops,
                "hbm_bw": self.hbm_bw, "link_bw": self.link_bw}


# Registry of known profiles, the reference package's four copied as they
# are (TPU numbers are published per-chip peaks; ``cpu`` is an
# order-of-magnitude stand-in for a few-core AVX host, for ranking blocks,
# not for absolute latency).  ``h100`` is NVIDIA's data sheet for the SXM
# part at 700 W: fp32 outside the tensor cores (no TF32, as the fp32 JPEG
# path runs), HBM3, and NVLink's 900 GB/s as 450 GB/s each way.
PROFILES: dict[str, HardwareProfile] = {
    "tpu-v5e": HardwareProfile("tpu-v5e", 197e12, 819e9, 50e9),
    "tpu-v4": HardwareProfile("tpu-v4", 275e12, 1228e9, 50e9),
    "gpu": HardwareProfile("gpu", 60e12, 1000e9, 25e9),
    "cpu": HardwareProfile("cpu", 100e9, 30e9, 10e9),
    "h100": HardwareProfile("h100", PEAK_FP32_FLOPS, PEAK_BYTES, 450e9),
}

ENV_VAR = "JPEG_HW_PROFILE"


def detect_backend() -> str:
    """The registry key of the device torch sees: ``h100`` for a CUDA
    device named H100, ``gpu`` for another CUDA device, ``cpu`` without
    CUDA."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    return "h100" if "H100" in torch.cuda.get_device_name(0) else "gpu"


def _parse_spec(spec: str) -> HardwareProfile:
    spec = spec.strip()
    if spec in PROFILES:
        return PROFILES[spec]
    parts = [p.strip() for p in spec.split(",")]
    if len(parts) == 3:
        try:
            flops, hbm, link = (float(p) for p in parts)
        except ValueError:
            pass
        else:
            return HardwareProfile("custom", flops, hbm, link)
    raise ValueError(
        f"unknown hardware profile {spec!r}: want one of "
        f"{sorted(PROFILES)} or a 'peak_flops,hbm_bw,link_bw' triple")


def resolve_profile(spec: str | None = None, *,
                    default: str | None = None) -> HardwareProfile:
    """Resolve the hardware profile to predict against.

    Priority: explicit ``spec`` (CLI) > ``JPEG_HW_PROFILE`` env var >
    ``default`` registry name > the detected device.  ``spec`` and
    the env var accept a registry name or a custom
    ``peak_flops,hbm_bw,link_bw`` triple.
    """
    if spec:
        return _parse_spec(spec)
    env = os.environ.get(ENV_VAR)
    if env:
        return _parse_spec(env)
    if default is not None:
        return PROFILES[default]
    return PROFILES[detect_backend()]


def roofline(flops: float, bytes_: float, collective_bytes: float,
             profile: HardwareProfile) -> dict:
    """The three roofline terms and the dominant one.

    Returns ``{"compute_s", "memory_s", "collective_s", "predicted_s",
    "term"}`` where ``predicted_s`` is the max term and ``term`` names
    it (``compute`` / ``memory`` / ``collective``).
    """
    terms = {
        "compute": flops / profile.peak_flops,
        "memory": bytes_ / profile.hbm_bw,
        "collective": collective_bytes / profile.link_bw,
    }
    dominant = max(terms, key=lambda k: terms[k])
    return {
        "compute_s": terms["compute"],
        "memory_s": terms["memory"],
        "collective_s": terms["collective"],
        "predicted_s": terms[dominant],
        "term": dominant,
    }
