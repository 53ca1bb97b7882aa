"""The JPEG transform-domain network: transform constants (``dct``), the
linear codec (``jpeg``), ASM ReLU (``asm``), convolution explosion
(``conv``), batch-norm folds, pooling, parameters (``resnet``), operator
dispatch, the inference plan (``plan``), model conversion (``convert``)
and transform-domain folding (``transform_linear``).
"""
from repro_torch.core import convert, transform_linear  # noqa: F401
