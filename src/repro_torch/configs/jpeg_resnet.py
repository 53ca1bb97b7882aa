"""The paper's own architecture: JPEG transform-domain ResNet (Fig. 3).

``full()`` is the ImageNet-scale variant; ``reduced()`` the paper's
CIFAR-scale network.  Same values as the reference package's config.
"""
from repro_torch.configs import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="jpeg-resnet", image_size=256, in_channels=3,
        widths=(64, 128, 256, 512), blocks_per_stage=2, num_classes=1000,
        asm_phi=14, source="[arXiv:1812.11690] scaled-up paper Fig. 3")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jpeg-resnet-reduced", image_size=32, in_channels=3,
        widths=(16, 32, 64), blocks_per_stage=1, num_classes=10, asm_phi=14,
        source="[arXiv:1812.11690] paper Fig. 3")


def spec_of(cfg: ModelConfig):
    """The ``ResNetSpec`` a config describes."""
    from repro_torch.core.resnet import ResNetSpec

    return ResNetSpec(in_channels=cfg.in_channels, widths=tuple(cfg.widths),
                      blocks_per_stage=cfg.blocks_per_stage,
                      num_classes=cfg.num_classes, phi=cfg.asm_phi)
