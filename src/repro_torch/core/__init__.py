"""The JPEG transform-domain network: transform constants (``dct``), the
linear codec (``jpeg``), ASM ReLU (``asm``), convolution explosion
(``conv``), batch-norm folds, pooling, parameters (``resnet``), operator
dispatch and the inference plan (``plan``).
"""
