"""Model and training configurations of the port: ``jpeg-resnet`` and every
language model of the reference (dense, MoE, Mamba hybrid, RWKV, VLM and
audio; full and reduced), the input shapes of the reference's cells
(:data:`SHAPES`), and the mesh and run configurations of the distributed
training path (``launch/steps.py``)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional

__all__ = ["ModelConfig", "ShapeConfig", "TrainConfig", "MeshConfig",
           "RunConfig", "SHAPES", "ARCHS", "register", "get_config",
           "reduced_config", "list_archs"]

#: arch → config module of the port
ARCHS = {"jpeg-resnet": "jpeg_resnet", "granite-3-2b": "granite_3_2b",
         "granite-moe-3b-a800m": "granite_moe_3b_a800m",
         "internvl2-1b": "internvl2_1b",
         "jamba-v0.1-52b": "jamba_v01_52b",
         "mistral-nemo-12b": "mistral_nemo_12b",
         "mixtral-8x7b": "mixtral_8x7b", "rwkv6-7b": "rwkv6_7b",
         "smollm-360m": "smollm_360m", "starcoder2-3b": "starcoder2_3b",
         "whisper-small": "whisper_small"}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's ``repro/configs/base.py:ModelConfig`` fields that the
    port reads: the LM fields of every family and the jpeg-resnet ones,
    same defaults."""

    name: str
    #: dense | moe | vlm | hybrid | ssm | audio | jpeg_resnet
    family: str = "jpeg_resnet"
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # MoE FFN on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # --- attention ---
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    attn_every: int = 1  # hybrid: attention where i % attn_every == offset
    attn_offset: int = 0
    use_rope: bool = True
    # --- SSM ---
    ssm_kind: Optional[str] = None  # 'mamba' | 'rwkv6'
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    rwkv_head_size: int = 64
    # --- encoder-decoder / multimodal ---
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    cross_attention: bool = False
    vision_prefix_len: int = 0  # patch embeddings prepended to the tokens
    frontend_stub: bool = False  # inputs are precomputed frame embeddings
    encoder_context_len: int = 1500  # encoder output length for decode
    # --- jpeg-resnet ---
    image_size: int = 32
    in_channels: int = 3
    widths: tuple[int, ...] = ()
    blocks_per_stage: int = 1
    num_classes: int = 10
    asm_phi: int = 14
    # --- numerics ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_attn_layer(self, i: int) -> bool:
        return (i % self.attn_every) == self.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and (i % self.moe_every) == self.moe_offset

    def sub_quadratic(self) -> bool:
        """Can this arch serve a 500k-token context (bounded attention
        state)?  As the reference answers it: an SSM or a hybrid, or a
        sliding window."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input shape of a cell: ``kind`` 'train', 'prefill' or
    'decode'."""

    name: str
    seq_len: int
    global_batch: int
    kind: str


#: the reference's four shapes (``repro/configs/base.py:99-104``)
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's training hyper-parameters
    (``repro/configs/base.py:TrainConfig``, same defaults).  The trainer
    (``launch/train.py``) reads the first seven; the mesh step
    (``launch/steps.py``) also the betas, ``eps``, ``grad_accum``,
    ``grad_compression`` and ``zero1``.  ``remat`` is the model's
    (``build_model(cfg, remat=...)``) and ``scan_layers`` has no effect:
    the port loops over its layers in Python."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1_000
    schedule: str = "cosine"          # 'cosine' | 'linear' | 'constant'
    optimizer: str = "adamw"          # 'adamw' | 'sgd' | 'lion'
    grad_clip: float = 1.0
    grad_accum: int = 1
    grad_compression: str = "none"    # 'none' | 'bf16'
    zero1: bool = True                # shard optimizer state over data
    remat: str = "full"               # 'none' | 'full' | 'dots'
    scan_layers: bool = True
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The device mesh: (pod, data, model) ranks, single-pod drops
    ``pod``."""

    multi_pod: bool = False
    pods: int = 2
    data: int = 16
    model: int = 16


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def _builtin(module: str, which: str) -> Callable[[], ModelConfig]:
    """``which`` ('full' or 'reduced') of a built-in config module,
    imported on its first call."""
    return lambda: getattr(
        importlib.import_module(f"repro_torch.configs.{module}"), which)()


#: arch → (full, reduced) config factories: the built-ins of
#: :data:`ARCHS` and whatever :func:`register` adds
_REGISTRY: dict[str, tuple[Callable[[], ModelConfig],
                           Callable[[], ModelConfig]]] = {
    arch: (_builtin(m, "full"), _builtin(m, "reduced"))
    for arch, m in ARCHS.items()}


def register(arch_id: str, full: Callable[[], ModelConfig],
             reduced: Callable[[], ModelConfig]) -> None:
    """Add ``arch_id`` to the registry (replacing a built-in one of that
    name): :func:`get_config` calls ``full()``, :func:`reduced_config`
    ``reduced()``."""
    _REGISTRY[arch_id] = (full, reduced)


def _factories(arch: str):
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; the port runs "
                       f"{', '.join(list_archs())}")
    return _REGISTRY[arch]


def get_config(arch: str) -> ModelConfig:
    """The full published configuration of ``arch``."""
    return _factories(arch)[0]()


def reduced_config(arch: str) -> ModelConfig:
    """A tiny same-family configuration of ``arch`` for CPU tests."""
    return _factories(arch)[1]()


def list_archs() -> list[str]:
    """Every arch the port configures (built in or registered), sorted."""
    return sorted(_REGISTRY)
