"""The rest of the port's ``config`` (slice 10), its native FITS codec and
``vip_ds9``, on the CPU.

- ``make_chunks``, ``Progressbar`` (tqdm, 'hide', and tqdm absent),
  ``redirect_output``, ``time_fin``, ``print_precision``; ``device_trace``
  writing a torch.profiler trace with an ``annotate_trace`` span; the
  seven telescope dictionaries equal to vip_tpu's.
- The codec (``fits/fits_io.cpp``, built with g++ here): its decode bit
  for bit equal to the port's plain numpy decode, and equal in value to
  vip_tpu's native decoder, for every BITPIX, scaled and not, in float32
  and float64 (vip_tpu scales unscaled data by 1.0 + 0.0 too, which turns
  -0.0 into 0.0: the test data hold no -0.0, and integers stay below 2**53
  so that int64 -> float64 -> float32 rounds once); the lazy HDU's
  slices; decoding into a caller's buffer; the encoder's bytes against
  the plain version's and vip_tpu's, and whole files against vip_tpu's
  writer; its errors; the build from several processes at once; a failed
  build raising, with no fallback.
- ``Ds9Window``: ``ImportError`` without pyds9, and host numpy arrays to
  a stub pyds9.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import vip_tpu_torch

import vip_tpu.config as jconf
import vip_tpu.fits as jfits
from vip_tpu.fits import _native as jnative
import vip_tpu_torch.config as tconf
from vip_tpu_torch.config import utils_conf
from vip_tpu_torch.fits import _native, open_fits, write_fits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BITPIX = {8: np.uint8, 16: ">i2", 32: ">i4", 64: ">i8", -32: ">f4",
          -64: ">f8"}
TELESCOPES = ("VLT_SPHERE_IFS", "VLT_SPHERE_IRDIS", "VLT_NACO",
              "VLT_SINFONI", "GPI_IFS", "LBT", "KECK_NIRC2")


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    vip_tpu_torch.set_device("cpu")


def test_make_chunks_and_pool_imap():
    for n in (1, 3, 5):
        assert tconf.make_chunks(range(13), n) == \
            jconf.make_chunks(range(13), n)
    got = list(utils_conf.pool_imap(1, lambda a, b: a * b,
                                    utils_conf.iterable([1, 2, 3]), 10))
    assert got == [10, 20, 30]


def test_progressbar_backends(monkeypatch):
    bar = tconf.Progressbar(range(3), desc="x")
    assert type(bar).__name__ == "tqdm" and list(bar) == [0, 1, 2]
    bar.close()
    hidden = tconf.Progressbar(range(3), backend="hide")
    assert isinstance(hidden, utils_conf.NoProgressbar)
    assert list(hidden) == [0, 1, 2]
    assert isinstance(tconf.Progressbar(range(2), verbose=False),
                      utils_conf.NoProgressbar)
    counter = tconf.Progressbar(total=4, backend="hide")
    counter.update()                        # counts nothing, says nothing
    monkeypatch.setitem(sys.modules, "tqdm", None)   # tqdm absent
    silent = tconf.Progressbar(range(2))
    assert isinstance(silent, utils_conf.NoProgressbar)
    assert list(silent) == [0, 1]
    try:
        tconf.Progressbar.set("hide")
        assert isinstance(tconf.Progressbar(range(2)),
                          utils_conf.NoProgressbar)
    finally:
        tconf.Progressbar.set("tqdm")
    with pytest.raises(NotImplementedError):
        tconf.Progressbar(range(2), backend="nope")


def test_redirect_output_time_fin_and_print_precision(tmp_path, capsys):
    path = tmp_path / "log.txt"
    with tconf.redirect_output(str(path)):
        print("into the file")
    print("to stdout")
    assert path.read_text() == "into the file\n"
    assert capsys.readouterr().out == "to stdout\n"
    start = tconf.time_ini(verbose=False)
    assert isinstance(tconf.time_fin(start), str)
    assert tconf.time_fin(start).startswith("0:00:")
    utils_conf.print_precision(torch.tensor([1.23456, 2.0]), 2)
    assert capsys.readouterr().out.strip() == "[1.23 2.  ]"
    assert (tconf.vip_figsize, tconf.vip_figdpi) == \
        (jconf.vip_figsize, jconf.vip_figdpi)


def test_device_trace_writes_a_trace(tmp_path):
    with tconf.device_trace(str(tmp_path)) as trace:
        with tconf.annotate_trace("vip-span"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "vip-span" for e in events)
    assert trace.profile.key_averages()


@pytest.mark.parametrize("name", TELESCOPES)
def test_telescope_dictionaries(name):
    assert getattr(tconf, name) == getattr(jconf, name)


def _block(tmp_path, bitpix, n, offset=17):
    """A file of ``offset`` junk bytes then ``n`` big-endian values of
    ``bitpix`` (seeded; no -0.0, integers far below 2**53)."""
    rng = np.random.default_rng(abs(bitpix))
    raw = rng.standard_normal(n) * 300
    if bitpix == 8:
        raw = np.abs(raw)
    raw = raw.astype(BITPIX[bitpix])
    raw[raw == 0] = 1
    path = str(tmp_path / f"block{bitpix}.bin")
    with open(path, "wb") as fh:
        fh.write(b"x" * offset + raw.tobytes())
    return path, offset


@pytest.mark.parametrize("precision", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("scale", [(1.0, 0.0), (2.5, -3.25), (1.0, 32768.0)],
                         ids=["raw", "scaled", "bzero"])
@pytest.mark.parametrize("bitpix", sorted(BITPIX))
def test_native_decode(tmp_path, bitpix, scale, precision):
    path, offset = _block(tmp_path, bitpix, 3000)
    args = (path, offset, (30, 100), bitpix, *scale, precision)
    got = _native.decode(*args)
    plain = _native._decode_plain(*args)
    assert got.dtype == np.dtype(precision) and got.shape == (30, 100)
    assert got.tobytes() == plain.tobytes()
    np.testing.assert_array_equal(got, jnative.decode(*args))


def test_decode_into_a_buffer(tmp_path):
    path, offset = _block(tmp_path, -32, 3000)
    want = _native._decode_plain(path, offset, (3, 1000), -32, 1.0, 0.0,
                                 np.float32)
    arr = np.empty(3000, np.float32)
    got = _native.decode(path, offset, (3, 1000), -32, 1.0, 0.0,
                         np.float32, out=arr)
    assert got.shape == (3, 1000) and np.shares_memory(got, arr)
    assert got.tobytes() == want.tobytes()
    ten = torch.empty((3, 1000), dtype=torch.float32)
    got = _native.decode(path, offset, (3, 1000), -32, 1.0, 0.0,
                         np.float32, out=ten)
    assert got.data_ptr() == ten.data_ptr()
    assert ten.numpy().tobytes() == want.tobytes()
    for bad in (np.empty(3000, np.float64), np.empty(2999, np.float32),
                torch.empty(3000, dtype=torch.float64),
                torch.empty((1000, 6), dtype=torch.float32)[:, ::2]):
        with pytest.raises(ValueError):
            _native.decode(path, offset, (3, 1000), -32, 1.0, 0.0,
                           np.float32, out=bad)


def test_decode_errors(tmp_path):
    path, offset = _block(tmp_path, 16, 100)
    with pytest.raises(OSError, match="does not open"):
        _native.decode(str(tmp_path / "none"), 0, (10,), 16, 1.0, 0.0,
                       np.float32)
    with pytest.raises(OSError, match="shorter"):
        _native.decode(path, offset, (101,), 16, 1.0, 0.0, np.float32)
    with pytest.raises(OSError, match="BITPIX"):
        _native.decode(path, offset, (10,), 12, 1.0, 0.0, np.float32)
    with pytest.raises(OSError, match="shorter"):
        _native._decode_plain(path, offset, (101,), 16, 1.0, 0.0,
                              np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_encode(dtype):
    arr = np.random.default_rng(3).standard_normal((7, 33)).astype(dtype)
    got = _native.encode(arr)
    assert got.dtype == np.uint8 and got.size == arr.nbytes
    assert got.tobytes() == _native._encode_plain(arr).tobytes()
    assert got.tobytes() == jnative.encode(arr)
    assert np.array_equal(np.frombuffer(got.tobytes(), arr.dtype
                                        .newbyteorder(">")), arr.ravel())
    with pytest.raises(TypeError):
        _native.encode(arr.astype(np.int32))


@pytest.mark.parametrize("precision", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_files_equal_vip_tpus_and_lazy_slices(tmp_path, precision):
    cube = np.random.default_rng(4).standard_normal((9, 12, 10))
    header = {"OBJECT": "beta Pic", "EXPTIME": 0.2}
    ours, theirs = str(tmp_path / "ours.fits"), str(tmp_path / "theirs.fits")
    write_fits(ours, cube, header=header, precision=precision, verbose=False)
    jfits.write_fits(theirs, cube, header=header, precision=precision,
                     verbose=False)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    full = open_fits(ours, precision=precision, verbose=False)
    assert full.dtype == np.dtype(precision)
    np.testing.assert_array_equal(full, cube.astype(precision))
    lazy = open_fits(ours, precision=precision, return_memmap=True)
    np.testing.assert_array_equal(lazy.data, full)
    for key in (0, 4, -1, slice(2, 6), slice(1, 9, 3), slice(None, None, -2),
                slice(5, 5)):
        np.testing.assert_array_equal(lazy[key], full[key])
    # two HDUs, both through the codec
    write_fits(ours, (cube[0], cube[:3]), precision=precision,
               verbose=False)
    data = open_fits(ours, n=-2, precision=precision, verbose=False)
    np.testing.assert_array_equal(data[1], full[:3])


_BUILDER = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from vip_tpu_torch.fits import _native
_native._SO = sys.argv[2]
arr = np.arange(50, dtype=np.float32)
path = sys.argv[3]
with open(path, "wb") as fh:
    fh.write(_native.encode(arr).tobytes())
assert np.array_equal(_native.decode(path, 0, (50,), -32, 1.0, 0.0,
                                     np.float32), arr)
print("ok")
"""


def test_build_from_several_processes_at_once(tmp_path):
    so = str(tmp_path / "build" / "libfits_io.so")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, REPO, so,
                               str(tmp_path / f"{i}.bin")],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "ok", err
    left = sorted(os.listdir(tmp_path / "build"))
    assert [f for f in left if f.endswith(".tmp")] == []
    assert "libfits_io.so" in left and "libfits_io.so.srchash" in left
    with open(so + ".srchash") as fh:
        assert fh.read() == _native._src_hash()


def test_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "fits_io.cpp"
    broken.write_text("int fits_decode_f32( {\n")
    monkeypatch.setattr(_native, "_SRC", str(broken))
    monkeypatch.setattr(_native, "_SO", str(tmp_path / "b" / "lib.so"))
    monkeypatch.setattr(_native, "_lib", None)
    with pytest.raises(RuntimeError, match="g..? failed") as err:
        _native.load()
    assert "fits_io.cpp" in str(err.value)
    cube = str(tmp_path / "c.fits")
    with open(cube, "wb"):
        pass
    with pytest.raises(RuntimeError, match="failed"):
        write_fits(cube, np.zeros((2, 2)), verbose=False)
    assert not os.path.exists(tmp_path / "b" / "lib.so")


def test_ds9_window(monkeypatch):
    from vip_tpu_torch.vip_ds9 import Ds9Window

    monkeypatch.setitem(sys.modules, "pyds9", None)
    with pytest.raises(ImportError, match="pyds9"):
        Ds9Window()
    calls = []

    class DS9:
        def __init__(self, wait):
            calls.append(("init", wait))

        def set(self, *args):
            calls.append(("set",) + args)

        def set_np2arr(self, array):
            calls.append(("array", array))

        def get(self, what):
            return what

    monkeypatch.setitem(sys.modules, "pyds9", types.SimpleNamespace(DS9=DS9))
    win = Ds9Window(wait=3)
    frame = torch.arange(6.0).reshape(2, 3)
    win.display(frame, np.ones((2, 2)))
    arrays = [c[1] for c in calls if c[0] == "array"]
    assert all(isinstance(a, np.ndarray) for a in arrays)
    np.testing.assert_array_equal(arrays[0], frame.numpy())
    assert calls[0] == ("init", 3) and ("set", "frame clear all") in calls
    assert ("set", "tile yes") in calls
    win.zoom(2)
    assert calls[-1] == ("set", "zoom 2")
    assert win.crosshair_get() == "crosshair"
