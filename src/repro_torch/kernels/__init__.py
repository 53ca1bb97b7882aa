"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``asm_relu``, ``jpeg_conv`` and ``fused_block`` each wrap a kernel of
``csrc/jpeg_kernels.cu`` (built by ``_build``) and count its launches;
``tiling`` holds the packed operators and plain executors they share.
"""
