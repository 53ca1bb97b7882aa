"""Every traffic generator is a pure function of the seed."""
from __future__ import annotations

import numpy as np
import torch

from conftest import BYTES, SEED, tiny


def test_images_follow_the_seed():
    from perfbench.traffic import images

    cpu = torch.device("cpu")
    a, la = images.synth(SEED, "images", 4, 32, 3, 10, cpu)
    b, lb = images.synth(SEED, "images", 4, 32, 3, 10, cpu)
    c, _ = images.synth(SEED + 1, "images", 4, 32, 3, 10, cpu)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert not torch.equal(a, c)
    assert a.min() >= images.PIXEL_MIN and a.max() <= images.PIXEL_MAX


def test_poisson_arrivals_reorder_one_set_of_gaps():
    from perfbench.traffic import poisson

    a = poisson.arrivals(30.0, 20.0, SEED)
    b = poisson.arrivals(30.0, 20.0, SEED)
    c = poisson.arrivals(30.0, 20.0, SEED + 1)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len(a) == len(c) == 600
    assert a[0] == 0.0 and a[-1] < 20.0 and np.all(np.diff(a) > 0)
    # the same gaps in another order: the seed changes no amount of work
    np.testing.assert_allclose(np.sort(np.diff(np.r_[a, 20.0])),
                               np.sort(np.diff(np.r_[c, 20.0])), rtol=1e-9)


def test_training_batches_follow_the_seed_and_all_rows_differ():
    from perfbench.lib import spec

    cell = tiny("jpeg-resnet-cifar.train-b1024")
    gen = spec.load_module("traffic", "train_batches")
    cpu = torch.device("cpu")
    args = (cell["config_data"], cell["workload"]["traffic"])
    a = gen.batches(*args, SEED, cpu)
    b = gen.batches(*args, SEED, cpu)
    assert all(torch.equal(x["coefficients"], y["coefficients"])
               and torch.equal(x["labels"], y["labels"])
               for x, y in zip(a, b))
    rows = torch.cat([x["coefficients"].flatten(1) for x in a])
    assert torch.unique(rows, dim=0).shape[0] == rows.shape[0]


def test_jfif_files_follow_the_seed_and_the_port_decodes_them():
    from perfbench.drivers import serve_qos
    from repro_torch.codec import ingest

    cell = tiny(BYTES)
    cfg, tr = cell["config_data"], cell["workload"]["traffic"]
    cpu = torch.device("cpu")
    pa, ref = serve_qos._payloads(cfg, tr, SEED, cpu)
    pb, _ = serve_qos._payloads(cfg, tr, SEED, cpu)
    assert pa == pb
    coef, _ = ingest.ingest_batch(pa[:2], quality=50, grid=(4, 4),
                                  channels=3, with_stats=False)
    from perfbench.reference import jpeg

    q = torch.as_tensor(jpeg.canonical_table(50), dtype=torch.float64)
    np.testing.assert_allclose(torch.as_tensor(coef).double() * q,
                               ref[:2].double(), atol=1e-5)
