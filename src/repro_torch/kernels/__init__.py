"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``asm_relu``, ``jpeg_conv`` and ``fused_block`` each wrap a kernel of
``csrc/jpeg_kernels.cu``, ``block_dct`` the kernel of ``csrc/block_dct.cu``,
``flash_attention`` the kernel of ``csrc/flash_attention.cu`` (all built by
``_build``), and count their launches; ``tiling`` holds the packed
operators and plain executors the JPEG kernels share.
"""
