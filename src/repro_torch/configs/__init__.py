"""Model and training configurations of the port (``jpeg-resnet`` full and
reduced)."""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "TrainConfig", "LM_ARCHS", "get_config",
           "reduced_config"]

#: the reference package's language-model archs, not ported yet
LM_ARCHS = ("granite-3-2b", "granite-moe-3b-a800m", "internvl2-1b",
            "jamba-v0.1-52b", "mistral-nemo-12b", "mixtral-8x7b",
            "rwkv6-7b", "smollm-360m", "starcoder2-3b", "whisper-small")


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's training hyper-parameters that the port's trainer
    reads (``repro/configs/base.py:TrainConfig``, same defaults)."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1_000
    schedule: str = "cosine"          # 'cosine' | 'linear' | 'constant'
    optimizer: str = "adamw"          # 'adamw' | 'sgd' | 'lion'
    grad_clip: float = 1.0


def _check(arch: str) -> None:
    if arch in LM_ARCHS:
        raise NotImplementedError(
            f"{arch!r} is a language model of the reference package; the "
            f"port runs jpeg-resnet only until the LM model zoo is ported "
            f"(ROADMAP Queue 1 item 7)")
    if arch != "jpeg-resnet":
        raise KeyError(f"unknown arch {arch!r}; the port runs jpeg-resnet")


def get_config(arch: str) -> ModelConfig:
    from repro_torch.configs import jpeg_resnet

    _check(arch)
    return jpeg_resnet.full()


def reduced_config(arch: str) -> ModelConfig:
    from repro_torch.configs import jpeg_resnet

    _check(arch)
    return jpeg_resnet.reduced()
