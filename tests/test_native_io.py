"""Native C++ ark I/O: build, roundtrip parity with the Python layer.

(ref: util/kaldi-table-test.cc — write/read-back equivalence over the
 table formats.)
"""

import io
import os

import numpy as np
import pytest

from kaldi_tpu.io import native
from kaldi_tpu.io.kaldi_io import read_ark, write_ark, read_scp


@pytest.fixture(scope="module")
def lib_ok():
    if not native.available():
        pytest.skip("g++ unavailable; native ark library not built")
    return True


def test_native_roundtrip(tmp_path, lib_ok):
    rng = np.random.RandomState(0)
    items = {f"utt{i}": rng.randn(10 + i, 7).astype(np.float32)
             for i in range(5)}
    items["vec"] = rng.randn(13).astype(np.float32)
    ark = str(tmp_path / "a.ark")
    scp = str(tmp_path / "a.scp")
    with native.ArkWriterNative(ark, scp) as w:
        for k, v in items.items():
            w.write(k, v)
    got = dict(native.read_ark_native(ark))
    assert set(got) == set(items)
    for k in items:
        np.testing.assert_allclose(got[k], items[k], atol=0)
    # scp index usable by the PYTHON reader (cross-impl parity)
    got2 = dict(read_scp(scp))
    for k in items:
        np.testing.assert_allclose(got2[k], items[k], atol=0)


def test_native_reads_python_written_ark(tmp_path, lib_ok):
    rng = np.random.RandomState(1)
    items = {"a": rng.randn(4, 3).astype(np.float32),
             "b": rng.randn(2, 6).astype(np.float32)}
    ark = str(tmp_path / "py.ark")
    write_ark(ark, items)
    got = dict(native.read_ark_native(ark))
    for k in items:
        np.testing.assert_allclose(got[k], items[k], atol=0)


def test_python_reads_native_written_ark(tmp_path, lib_ok):
    rng = np.random.RandomState(2)
    items = {"x": rng.randn(8, 5).astype(np.float32)}
    ark = str(tmp_path / "n.ark")
    with native.ArkWriterNative(ark) as w:
        for k, v in items.items():
            w.write(k, v)
    got = dict(read_ark(ark))
    np.testing.assert_allclose(got["x"], items["x"], atol=0)


def test_read_ark_fast_path_dispatch(tmp_path, lib_ok):
    """read_ark must transparently use the native reader for plain binary
    FM arks and fall back for compressed ones."""
    rng = np.random.RandomState(3)
    plain = {"u1": rng.randn(20, 4).astype(np.float32)}
    ark1 = str(tmp_path / "plain.ark")
    write_ark(ark1, plain)
    got = dict(read_ark(ark1))
    np.testing.assert_allclose(got["u1"], plain["u1"], atol=0)

    ark2 = str(tmp_path / "comp.ark")
    write_ark(ark2, plain, compress=True)
    got2 = dict(read_ark(ark2))   # python CM path
    assert np.abs(got2["u1"] - plain["u1"]).max() < 0.05


def test_read_ark_dispatches_to_native(tmp_path, monkeypatch):
    """Regression: _classify(name) == 'file' compared a tuple to a string,
    so the native fast path was dead code."""
    import numpy as np
    from kaldi_tpu.io import native
    from kaldi_tpu.io.kaldi_io import write_ark, read_ark
    if not native.available():
        import pytest
        pytest.skip("native ark reader not built")
    m = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = str(tmp_path / "x.ark")
    write_ark(p, [("u1", m)])
    called = {}
    orig = native.read_ark_native

    def spy(path):
        called["yes"] = True
        return orig(path)

    monkeypatch.setattr(native, "read_ark_native", spy)
    items = list(read_ark(p))
    assert called.get("yes"), "native fast path not taken for a plain ark"
    assert items[0][0] == "u1"
    np.testing.assert_allclose(items[0][1], m)


def test_read_ark_mixed_entries_no_duplicates(tmp_path):
    """Regression: when the native reader fails mid-stream on an entry
    type it doesn't handle, the Python fallback must not re-yield the
    entries the native reader already produced."""
    import numpy as np
    from kaldi_tpu.io.kaldi_io import write_ark, read_ark
    m = np.arange(6, dtype=np.float32).reshape(2, 3)
    ali = np.array([1, 2, 3], np.int32)
    p = str(tmp_path / "mixed.ark")
    write_ark(p, [("a", m), ("b", ali), ("c", m + 1.0)])
    items = list(read_ark(p))
    assert [k for k, _v in items] == ["a", "b", "c"]
    np.testing.assert_allclose(items[0][1], m)
    np.testing.assert_allclose(items[2][1], m + 1.0)


def test_native_rebuilds_when_source_is_newer(tmp_path, monkeypatch,
                                              lib_ok):
    """A library older than ark_io.cc is rebuilt from the source, as the
    fst and lattice libraries are."""
    import shutil
    src = tmp_path / "ark_io.cc"
    so = tmp_path / "libkaldi_tpu_ark.so"
    shutil.copyfile(native._SRC, src)
    so.write_bytes(b"stale")                    # not a loadable library
    os.utime(so, (1_000_000, 1_000_000))
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_SO", str(so))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native._load() is not None
    assert so.stat().st_mtime > src.stat().st_mtime - 1
    assert so.read_bytes()[:4] == b"\x7fELF"
