"""The kernel build's orchestration (``kernels/_build.py``) with a stand-in
compiler: one compile per source, all started before any finishes, then
one link; objects removed; the library named by a hash of the sources and
reused; a failing source named in the error.  The real ``nvcc`` runs only
on the card (``chip_smoke.py``)."""
import os
import stat
import sys

import pytest

from repro_torch.kernels import _build

FAKE_NVCC = r'''#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
log = os.environ["FAKE_NVCC_LOG"]
if "-c" in args:
    src = args[args.index("-c") + 1]
    with open(log, "a") as f:
        f.write(f"start {{os.path.basename(src)}} {{time.monotonic()}}\n")
    if os.path.basename(src) == os.environ.get("FAKE_NVCC_FAIL"):
        print(f"{{src}}: error: broken", file=sys.stderr)
        sys.exit(2)
    time.sleep(0.3)
    with open(out, "w") as f:
        f.write(src)
    with open(log, "a") as f:
        f.write(f"done {{os.path.basename(src)}} {{time.monotonic()}}\n")
    print(f"ptxas info    : Used 1 registers ({{os.path.basename(src)}})",
          file=sys.stderr)
else:
    objs = [a for a in args if a.endswith(".o")]
    assert all(os.path.exists(o) for o in objs), objs
    with open(out, "w") as f:
        f.write("\n".join(objs))
    with open(log, "a") as f:
        f.write(f"link {{len(objs)}}\n")
'''


@pytest.fixture
def fake(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "log"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOG", {})
    return log


def test_sources_compile_in_parallel_then_link(fake):
    lib = _build.build()
    assert lib.parent == _build.BUILD_DIR and lib.exists()
    lines = fake.read_text().splitlines()
    names = sorted(src.name for src in _build.SOURCES)
    assert "flash_attention.cu" in names and len(names) >= 3
    starts = {ln.split()[1]: float(ln.split()[2]) for ln in lines
              if ln.startswith("start")}
    dones = [float(ln.split()[2]) for ln in lines if ln.startswith("done")]
    assert sorted(starts) == names
    assert max(starts.values()) < min(dones)  # all started before any ended
    assert lines[-1] == f"link {len(names)}"
    assert sorted(os.listdir(_build.BUILD_DIR)) == [lib.name]  # no objects
    log = _build.build_log()
    assert not log["cached"] and log["seconds"] > 0
    assert all(f"({n})" in log["ptxas"] for n in names)
    assert _build.build() == lib  # the same sources: reused, not rebuilt
    assert fake.read_text().count("link") == 1


def test_a_failing_source_is_named(fake, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "flash_attention.cu")
    with pytest.raises(RuntimeError, match="flash_attention.cu.*broken"):
        _build.build()
    assert "link" not in fake.read_text()
    assert not _build.BUILD_DIR.exists() or not os.listdir(_build.BUILD_DIR)


def test_edited_copies_build_into_their_own_directory(fake, tmp_path):
    out = tmp_path / "variant"
    out.mkdir()
    copies = []
    for src in _build.SOURCES:
        copies.append(out / src.name)
        copies[-1].write_text(src.read_text() + "\n// a variant\n")
    lib = _build.build(copies, out)
    assert lib.parent == out and lib.exists()
    assert not _build.BUILD_DIR.exists()  # the committed build is untouched
    assert all(str(out) in line for line in lib.read_text().splitlines())
    started = [ln.split()[1] for ln in fake.read_text().splitlines()
               if ln.startswith("start")]
    assert sorted(started) == sorted(src.name for src in _build.SOURCES)
    assert sorted(os.listdir(out)) == sorted([lib.name, *started])
    assert _build.build() != lib  # other source text, another library
