"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``asm_relu``, ``jpeg_conv`` and ``fused_block`` each wrap a kernel of
``csrc/jpeg_kernels.cu``, ``block_dct`` the kernel of ``csrc/block_dct.cu``,
``flash_attention`` the kernel of ``csrc/flash_attention.cu`` (all built by
``_build``), and count their launches; ``tiling`` holds the packed
operators and plain executors the JPEG kernels share.
"""

__all__ = ["launch_counts", "set_launch_counts"]


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's count of launches, by kernel name."""
    from repro_torch.kernels import asm_relu, block_dct, flash_attention, \
        fused_block, jpeg_conv

    return {"fused_block": fused_block.LAUNCHES,
            "jpeg_conv": jpeg_conv.LAUNCHES, "asm_relu": asm_relu.LAUNCHES,
            **block_dct.LAUNCHES,
            "flash_attention": flash_attention.LAUNCHES}


def set_launch_counts(counts: dict[str, int]) -> None:
    """Set the wrappers' counts (``{name: 0}`` resets one); a name not in
    ``counts`` keeps its count."""
    from repro_torch.kernels import asm_relu, block_dct, flash_attention, \
        fused_block, jpeg_conv

    mods = {"fused_block": fused_block, "jpeg_conv": jpeg_conv,
            "asm_relu": asm_relu, "flash_attention": flash_attention}
    for name, n in counts.items():
        if name in block_dct.LAUNCHES:
            block_dct.LAUNCHES[name] = int(n)
        else:
            mods[name].LAUNCHES = int(n)
