"""The port's ingest machinery against the reference package's codec.

``ingest_batch`` (batches, ``IngestStats`` and per-image errors under
``on_error="isolate"``) is bit-exact against the reference's scalar
ingest on every committed fixture, in-process and through the spawn pool
(``JPEG_INGEST_WORKERS=2``); corrupt bytes raise the reference's
``CodecError`` subclass with its message; a killed pool worker is
respawned and counted; ``ingest_pipeline`` yields the sequential loop's
batches; a batch of 8 images without restart markers takes the scalar
decoder, and both decoders agree bit for bit on such batches and on DRI
ones; ``--jpeg-dir`` reads the same files as the reference.  Tolerance:
none — every comparison is exact.
"""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from repro.codec import ingest as ref_ing
from repro.data import pipeline as ref_pipe
from repro.launch import serve as ref_serve
from repro_torch.codec import CodecError
from repro_torch.codec import bitstream as bs
from repro_torch.codec import encode as enc
from repro_torch.codec import ingest as ing
from repro_torch.codec import lockstep as lk
from repro_torch.configs import reduced_config
from repro_torch.data import pipeline as pipe
from repro_torch.data.synthetic import image_batch
from repro_torch.launch import serve

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "codec")
FIXTURES = sorted(n[:-4] for n in os.listdir(FIXDIR) if n.endswith(".jpg"))
KW = dict(quality=50, grid=(5, 5), channels=3)


def _bytes(name):
    with open(os.path.join(FIXDIR, name + ".jpg"), "rb") as f:
        return f.read()


def _traffic():
    """Every fixture, twice over, with a truncated and a marker-corrupted
    copy among them."""
    datas = [_bytes(n) for n in FIXTURES] * 2
    datas[1] = datas[1][: len(datas[1]) // 2]
    bad = bytearray(datas[4])
    sos = bad.find(b"\xff\xda")
    ecs = sos + 2 + int.from_bytes(bad[sos + 2:sos + 4], "big")
    bad[ecs + 8:ecs + 10] = b"\xff\xc7"
    datas[4] = bytes(bad)
    return datas


def _assert_stats_equal(a, b):
    assert (a.images, a.blocks, a.bytes_in) == (b.images, b.blocks,
                                                b.bytes_in)
    assert np.array_equal(a.energy, b.energy)
    assert np.array_equal(a.occupancy, b.occupancy)


def _assert_errors_equal(got, want):
    assert sorted(got) == sorted(want)
    for i, e in want.items():
        assert type(got[i]).__name__ == type(e).__name__
        assert isinstance(got[i], CodecError)
        assert str(got[i]) == str(e)


@pytest.mark.parametrize("workers", ["1", "2"])
@pytest.mark.parametrize("pack", [None, 24])
def test_isolated_batches_stats_errors_bit_exact(monkeypatch, workers, pack):
    datas = _traffic()
    want, wst, werr = ref_ing.ingest_batch(datas, parallel=False,
                                           on_error="isolate",
                                           pack_width=pack, **KW)
    monkeypatch.setenv("JPEG_INGEST_WORKERS", workers)
    shards = []
    try:
        got, st, err = ing.ingest_batch(
            datas, on_error="isolate", pack_width=pack,
            on_shard=lambda idx, a, b: shards.append(idx), **KW)
    finally:
        ing.shutdown_pool()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    _assert_stats_equal(st, wst)
    _assert_errors_equal(err, werr)
    assert sorted(i for s in shards for i in s) == (
        list(range(len(datas))) if workers == "2" else [])


@pytest.mark.parametrize("name", FIXTURES)
def test_clean_fixture_batches_bit_exact(monkeypatch, name):
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    datas = [_bytes(name)] * 3
    got, st = ing.ingest_batch(datas, **KW)
    want, wst = ref_ing.ingest_batch(datas, parallel=False, **KW)
    assert np.array_equal(got, want)
    _assert_stats_equal(st, wst)


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("frac", [0.1, 0.55, 0.97])
def test_corrupt_bytes_raise_the_references_error(monkeypatch, name, frac):
    """The fuzz contract (``test_codec_fuzz.py``): a truncated file fails
    alone under ``isolate``, with the reference's error type and message;
    ``on_error="raise"`` raises it."""
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    data = _bytes(name)
    cut = data[: max(1, int(len(data) * frac))]
    datas = [_bytes(FIXTURES[0]), cut, _bytes(FIXTURES[-1])]
    got, _, err = ing.ingest_batch(datas, on_error="isolate", **KW)
    want, _, werr = ref_ing.ingest_batch(datas, parallel=False,
                                         on_error="isolate", **KW)
    assert np.array_equal(got, want) and got.shape[0] == 2
    _assert_errors_equal(err, werr)
    with pytest.raises(CodecError) as ei:
        ing.ingest_batch(datas, **KW)
    assert type(ei.value).__name__ == type(werr[1]).__name__


def test_all_failed_batch_has_the_empty_shape(monkeypatch):
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    got, st, err = ing.ingest_batch([b"\x00junk", b"\xff\xd8"],
                                    on_error="isolate", pack_width=16, **KW)
    assert got.shape == (0, 5, 5, 48) and sorted(err) == [0, 1]
    assert st.images == 0
    with pytest.raises(ValueError, match="on_error"):
        ing.ingest_batch([b""], on_error="ignore")


def test_killed_worker_is_respawned_and_counted(monkeypatch):
    """As ``test_chaos.py``'s pool assertions: SIGKILL a live worker, the
    next batch still decodes (bit-exact), ``pool_restarts`` ticks."""
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "2")
    datas = [_bytes(n) for n in FIXTURES] * 2
    want, _ = ref_ing.ingest_batch(datas, parallel=False, **KW)
    try:
        ing.ingest_batch(datas[:2], **KW)  # a live pool to kill
        procs = [p for p in ing._POOL._processes.values() if p.is_alive()]
        assert procs
        before = ing.pool_restarts()
        os.kill(procs[0].pid, signal.SIGKILL)
        procs[0].join(timeout=30)
        got, _ = ing.ingest_batch(datas, **KW)
        assert ing.pool_restarts() == before + 1
        assert np.array_equal(got, want)
    finally:
        ing.shutdown_pool()


def test_supervision_exhausted_decodes_in_process(monkeypatch):
    """With no respawn left the batch decodes in-process, still exact."""
    from concurrent.futures.process import BrokenProcessPool

    monkeypatch.setenv("JPEG_INGEST_WORKERS", "2")
    monkeypatch.setenv("JPEG_POOL_MAX_RESTARTS", "0")
    assert ing.pool_max_restarts() == 0

    class Broken:
        def submit(self, *a, **k):
            raise BrokenProcessPool("dead")

    monkeypatch.setattr(ing, "_get_pool", lambda workers: Broken())
    before = ing.pool_restarts()
    datas = [_bytes(n) for n in FIXTURES]
    got, _ = ing.ingest_batch(datas, **KW)
    want, _ = ref_ing.ingest_batch(datas, parallel=False, **KW)
    assert np.array_equal(got, want)
    assert ing.pool_restarts() == before + 1


def test_pipeline_yields_the_sequential_batches(monkeypatch):
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    datas = [_bytes(FIXTURES[i % len(FIXTURES)]) for i in range(8)]
    chunks = [datas[:4], datas[4:6], datas[6:]]
    outs = list(ing.ingest_pipeline(chunks, depth=2, **KW))
    for (got, st), chunk in zip(outs, chunks):
        want, wst = ref_ing.ingest_batch(chunk, parallel=False, **KW)
        assert np.array_equal(got, want)
        _assert_stats_equal(st, wst)
    # the consumer walking away joins the producer
    before = threading.active_count()
    gen = ing.ingest_pipeline(iter(lambda: datas[:2], None), depth=2, **KW)
    next(gen)
    gen.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before
    # a decode error re-raises at the consumer
    gen = ing.ingest_pipeline([datas[:1], [b"\xff\xd8 broken"]], **KW)
    next(gen)
    with pytest.raises(CodecError):
        next(gen)


def _encoded(n, size, restart):
    imgs = image_batch(0, 1, n, size, 3, 10)["images"]
    return [enc.encode_pixels(np.clip(x, -1.0, 127.0 / 128.0), quality=50,
                              restart_interval=restart) for x in imgs]


@pytest.mark.parametrize("restart", [0, 1])
def test_lockstep_and_scalar_agree(restart):
    """Bit for bit, on a batch of 8 without restart markers (8 streams)
    and one with a restart every MCU (128 streams)."""
    scans = [bs.prepare_scan(d) for d in _encoded(8, 32, restart)]
    lock = lk.decode_scans(scans)
    for a, sc in zip(lock, scans):
        b = bs.decode_scan(sc)
        for ca, cb in zip(a.coefficients, b.coefficients):
            assert np.array_equal(ca, cb)
    assert lk.count_streams(scans) == (8 if restart == 0 else 8 * 16)


def test_no_dri_batch_of_8_takes_the_scalar_decoder(monkeypatch):
    """The repaired choice: 8 streams clear ``LOCKSTEP_MIN_STREAMS`` (the
    reference would go lockstep) but spread the symbols over ~8 streams,
    below ``LOCKSTEP_MIN_PARALLEL``; a DRI batch goes lockstep."""
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    calls = []
    real = lk.decode_scans
    monkeypatch.setattr(lk, "decode_scans",
                        lambda scans: calls.append(len(scans)) or real(scans))
    no_dri = _encoded(8, 64, 0)
    scans = [bs.prepare_scan(d) for d in no_dri]
    assert lk.count_streams(scans) >= lk.LOCKSTEP_MIN_STREAMS
    assert lk.parallelism(scans) < lk.LOCKSTEP_MIN_PARALLEL
    assert not lk.prefers_lockstep(scans)
    got, _ = ing.ingest_batch(no_dri, grid=(8, 8))
    assert calls == []
    want, _ = ref_ing.ingest_batch(no_dri, grid=(8, 8), parallel=False)
    assert np.array_equal(got, want)
    dri = _encoded(8, 64, 1)
    assert lk.prefers_lockstep([bs.prepare_scan(d) for d in dri])
    got, _ = ing.ingest_batch(dri, grid=(8, 8))
    assert calls == [8]
    want, _ = ref_ing.ingest_batch(dri, grid=(8, 8), parallel=False)
    assert np.array_equal(got, want)


def test_ingest_workers_env(monkeypatch):
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "3")
    assert ing.ingest_workers() == ref_ing.ingest_workers() == 3
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "0")
    assert ing.ingest_workers() == 1
    monkeypatch.delenv("JPEG_INGEST_WORKERS")
    assert ing.ingest_workers() == (os.cpu_count() or 1)
    monkeypatch.setenv("JPEG_POOL_MAX_RESTARTS", "5")
    assert ing.pool_max_restarts() == ref_ing.pool_max_restarts() == 5


def test_jpeg_dir_reads_what_the_reference_reads(monkeypatch):
    """``list_jpeg_files``, ``jpeg_file_iterator`` and ``serve
    --jpeg-dir``'s request source against the reference's."""
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    assert pipe.list_jpeg_files(FIXDIR) == ref_pipe.list_jpeg_files(FIXDIR)
    kw = dict(grid=(5, 5), channels=3, quality=50, seed=3, pack_width=16)
    got, want = (pipe.jpeg_file_iterator(FIXDIR, 4, **kw),
                 ref_pipe.jpeg_file_iterator(FIXDIR, 4, **kw))
    for _ in range(2):
        a, b = next(got), next(want)
        assert np.array_equal(a["coefficients"],
                              np.asarray(b["coefficients"]))
        assert np.array_equal(a["labels"], np.asarray(b["labels"]))
    assert got.state_dict() == {"seed": 3, "step": 2}
    cfg = reduced_config("jpeg-resnet")
    args = serve.parse_args(["--arch", "jpeg-resnet", "--reduced",
                             "--ingest", "bytes", "--jpeg-dir", FIXDIR,
                             "--batch", "3"])
    mine = serve.jpeg_byte_requests(args.batch, cfg, 5, args.jpeg_dir)
    ref = ref_serve.jpeg_byte_requests(args, cfg, 5)
    for step in range(3):
        assert mine(step) == ref(step)
    with pytest.raises(FileNotFoundError):
        serve.jpeg_byte_requests(2, cfg, 0, os.path.dirname(FIXDIR)
                                 + "/no_such_dir")
