#!/usr/bin/env python3
"""Where the lockstep entropy decoder beats the scalar one, on this host.

    PYTHONPATH=src python3 tools/lockstep_crossover.py

Encodes batches of synthetic images (``data.synthetic``) at several sizes,
batch sizes and restart intervals, decodes each batch with both decoders
of ``repro_torch.codec`` in this process, and prints one row a batch: the
restart streams, ``lockstep.parallelism`` (entropy-coded bytes over the
longest stream's), both times, their ratio and which decoder
``lockstep.prefers_lockstep`` picks.  The crossover (ratio 1) sets
``lockstep.LOCKSTEP_MIN_PARALLEL``.  Host work only: no device is used.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.codec import bitstream as bs  # noqa: E402
from repro_torch.codec import encode as enc  # noqa: E402
from repro_torch.codec import lockstep as lk  # noqa: E402
from repro_torch.data.synthetic import image_batch  # noqa: E402

#: (image size, images, restart interval in MCUs; 0 = no restart markers)
CASES = ((256, 8, 0), (128, 8, 0), (64, 8, 0), (64, 32, 0), (32, 64, 0),
         (128, 8, 64), (256, 8, 64), (128, 8, 16), (256, 8, 16),
         (64, 16, 4), (256, 8, 4))


def best_of(fn, reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main() -> None:
    print(f"host: {os.cpu_count()} CPUs, python {sys.version.split()[0]}")
    print("size images restart streams parallelism lockstep_s scalar_s "
          "ratio choice")
    for size, n, restart in CASES:
        imgs = image_batch(0, 0, n, size, 3, 10)["images"]
        datas = [enc.encode_pixels(np.clip(x, -1.0, 127.0 / 128.0),
                                   quality=50, restart_interval=restart)
                 for x in imgs]
        scans = [bs.prepare_scan(d) for d in datas]
        t_lock = best_of(lambda: lk.decode_scans(scans))
        t_scalar = best_of(lambda: [bs.decode_scan(s) for s in scans])
        choice = "lockstep" if lk.prefers_lockstep(scans) else "scalar"
        print(f"{size} {n} {restart} {lk.count_streams(scans)} "
              f"{lk.parallelism(scans):.1f} {t_lock:.4f} {t_scalar:.4f} "
              f"{t_lock / t_scalar:.3f} {choice}", flush=True)


if __name__ == "__main__":
    main()
