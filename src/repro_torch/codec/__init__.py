"""Compressed-ingest codec: JPEG bytes → the compiled plan's input.

A baseline JFIF parser and vectorized numpy Huffman decoder
(:mod:`~repro_torch.codec.bitstream`, :mod:`~repro_torch.codec.lockstep`),
the matching entropy encoder (:mod:`~repro_torch.codec.encode`),
per-image quantization normalization (:mod:`~repro_torch.codec.normalize`)
and batched ingest over a supervised decode pool
(:mod:`~repro_torch.codec.ingest`).  Numpy only: the
codec runs on the host and hands its batch to the device.
"""
from repro_torch.codec.bitstream import (  # noqa: F401
    CodecError, DecodedJpeg, decode_jpeg, decode_scan, prepare_scan,
)
from repro_torch.codec.encode import encode_pixels  # noqa: F401
from repro_torch.codec.normalize import normalize_image  # noqa: F401
from repro_torch.codec.ingest import (  # noqa: F401
    IngestStats, decode_bytes, ingest_batch, ingest_pipeline,
    ingest_workers, merge_stats, pack_tiles, pool_restarts, shutdown_pool,
)

__all__ = ["CodecError", "DecodedJpeg", "decode_jpeg", "decode_scan",
           "prepare_scan", "encode_pixels", "normalize_image",
           "IngestStats", "decode_bytes", "ingest_batch", "ingest_pipeline",
           "ingest_workers", "merge_stats", "pack_tiles", "pool_restarts",
           "shutdown_pool"]
