"""Model configurations the port serves (``jpeg-resnet`` full and reduced)."""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "get_config", "reduced_config"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    image_size: int
    in_channels: int
    widths: tuple[int, ...]
    blocks_per_stage: int
    num_classes: int
    asm_phi: int = 14
    source: str = ""


def get_config(arch: str) -> ModelConfig:
    from repro_torch.configs import jpeg_resnet

    if arch != "jpeg-resnet":
        raise KeyError(f"unknown arch {arch!r}; the port serves jpeg-resnet")
    return jpeg_resnet.full()


def reduced_config(arch: str) -> ModelConfig:
    from repro_torch.configs import jpeg_resnet

    if arch != "jpeg-resnet":
        raise KeyError(f"unknown arch {arch!r}; the port serves jpeg-resnet")
    return jpeg_resnet.reduced()
