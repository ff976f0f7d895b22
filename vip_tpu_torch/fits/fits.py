"""FITS file I/O (port of ``vip_tpu.fits.fits``; the port keeps its own
copy and imports nothing of vip_tpu).

Self-contained reader/writer for the FITS standard (primary + IMAGE
extensions): 2880-byte blocks, 80-char header cards, big-endian data with
BSCALE/BZERO. The data blocks go through the native codec
(``_native.py``: ``fits_io.cpp``, a multithreaded mmap decoder and
encoder, built with g++ at its first use). ``open_fits(...,
return_memmap=True)`` returns a lazy HDU whose frame slices decode only
the frames asked for, the contract ``psfsub.pca_incremental`` streams on;
its ``_read_frames`` decodes into a caller's buffer (pinned memory).
"""

from os import remove
from os.path import exists, isfile

import numpy as np

from . import _native
from .headers import BLOCK, CARD, Header

__all__ = ["open_fits", "info_fits", "write_fits", "verify_fits",
           "byteswap_array"]

ALL_FITS = -2


def _read_header_blocks(fh):
    """Read header blocks until the END card; returns (Header, data_offset
    is implicit via file position)."""
    cards = []
    while True:
        block = fh.read(BLOCK)
        if len(block) < BLOCK:
            if not block:
                return None
            raise OSError("Truncated FITS header")
        text = block.decode("ascii", errors="replace")
        done = False
        for i in range(0, BLOCK, CARD):
            card = text[i:i + CARD]
            if card[:8].rstrip() == "END":
                done = True
                break
            cards.append(card)
        if done:
            return Header.fromcards(cards)


def _scan_hdus(path):
    """Scan all HDUs: list of dicts with header, data offset, shape,
    bitpix, nbytes."""
    hdus = []
    with open(path, "rb") as fh:
        while True:
            header = _read_header_blocks(fh)
            if header is None:
                break
            offset = fh.tell()
            naxis = int(header.get("NAXIS", 0))
            dims = [int(header["NAXIS{}".format(i + 1)])
                    for i in range(naxis)]
            shape = tuple(dims[::-1])  # FITS is Fortran-ordered
            bitpix = int(header.get("BITPIX", 8))
            nel = int(np.prod(shape)) if shape else 0
            nbytes = nel * abs(bitpix) // 8
            padded = ((nbytes + BLOCK - 1) // BLOCK) * BLOCK
            hdus.append(dict(header=header, offset=offset, shape=shape,
                             bitpix=bitpix, nbytes=nbytes))
            fh.seek(offset + padded)
    return hdus


def _read_hdu_data(path, hdu, precision=np.float32, out=None):
    """Decode the data block of one scanned HDU into a native float array
    (into ``out`` when given: see ``_native.decode``)."""
    shape = hdu["shape"]
    if not shape or hdu["nbytes"] == 0:
        return None
    header = hdu["header"]
    bscale = float(header.get("BSCALE", 1.0))
    bzero = float(header.get("BZERO", 0.0))
    if hdu["bitpix"] not in _native._BITPIX_DTYPE:
        raise ValueError("Unsupported BITPIX value {} in FITS header of {}"
                         .format(hdu["bitpix"], path))
    return _native.decode(path, hdu["offset"], shape, hdu["bitpix"], bscale,
                          bzero, precision, out=out)


def open_fits(fitsfilename, n=0, header=False, ignore_missing_end=False,
              precision=np.float32, return_memmap=False, verbose=True,
              **kwargs):
    """Load a FITS file (reference fits.py:23-117).

    ``n`` selects the HDU; -2 returns all. ``header=True`` also returns the
    header(s). ``return_memmap=True`` returns a lazy reader for the HDU.
    """
    fitsfilename = str(fitsfilename)
    if not isfile(fitsfilename):
        fitsfilename += ".fits"
    hdus = _scan_hdus(fitsfilename)

    if n == ALL_FITS:
        if return_memmap:
            return [_LazyHDU(fitsfilename, h, precision) for h in hdus]
        data_list = []
        header_list = []
        for index, hdu in enumerate(hdus):
            data = _read_hdu_data(fitsfilename, hdu, precision)
            if verbose:
                shp = data.shape if data is not None else ()
                print("FITS HDU-{} data successfully loaded. Data shape: "
                      "{}".format(index, shp))
            data_list.append(data)
            header_list.append(hdu["header"])
        if header:
            if verbose:
                print("All {} FITS HDU data and headers successfully "
                      "loaded.".format(len(hdus)))
            return data_list, header_list
        if verbose:
            print("All {} FITS HDU data successfully loaded."
                  .format(len(hdus)))
        return data_list

    if return_memmap:
        return _LazyHDU(fitsfilename, hdus[n], precision)
    data = _read_hdu_data(fitsfilename, hdus[n], precision)
    if verbose:
        shp = data.shape if data is not None else ()
        if header:
            print("FITS HDU-{} data and header successfully loaded. Data "
                  "shape: {}".format(n, shp))
        else:
            print("FITS HDU-{} data successfully loaded. Data shape: "
                  "{}".format(n, shp))
    if header:
        return data, hdus[n]["header"]
    return data


class _LazyHDU:
    """Memmap-style lazy HDU handle: data decoded on access.

    Slicing along the leading (frame) axis decodes ONLY the requested
    byte range — the out-of-core contract pca_incremental relies on
    (reference fits.py:23 ``return_memmap`` + utils_pca.py:431-614).
    """

    def __init__(self, path, hdu, precision):
        self._path = path
        self._hdu = hdu
        self._precision = precision
        self.header = hdu["header"]
        self.shape = hdu["shape"]
        self.ndim = len(self.shape)
        itemsize = abs(hdu["bitpix"]) // 8
        self.nbytes = int(np.prod(self.shape)) * itemsize if self.shape \
            else 0

    def __len__(self):
        return self.shape[0] if self.shape else 0

    @property
    def data(self):
        return _read_hdu_data(self._path, self._hdu, self._precision)

    def _read_frames(self, start, stop, out=None):
        """Decode frames [start, stop) of the leading axis only (into
        ``out``, a contiguous CPU buffer of the lazy HDU's precision, when
        given)."""
        n = self.shape[0]
        start = max(0, min(start, n))
        stop = max(start, min(stop, n))
        per_frame = int(np.prod(self.shape[1:])) if self.ndim > 1 else 1
        itemsize = abs(self._hdu["bitpix"]) // 8
        sub = dict(self._hdu)
        sub["offset"] = self._hdu["offset"] + start * per_frame * itemsize
        sub["shape"] = (stop - start,) + tuple(self.shape[1:])
        sub["nbytes"] = (stop - start) * per_frame * itemsize
        return _read_hdu_data(self._path, sub, self._precision, out=out)

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            idx = int(key) + (self.shape[0] if key < 0 else 0)
            return self._read_frames(idx, idx + 1)[0]
        if isinstance(key, slice):
            wanted = range(*key.indices(self.shape[0]))
            if len(wanted) == 0:
                first = self._read_frames(0, min(1, self.shape[0]))
                dtype = first.dtype if first is not None else np.float64
                return np.empty((0,) + tuple(self.shape[1:]), dtype)
            lo, hi = min(wanted), max(wanted)
            block = self._read_frames(lo, hi + 1)
            return block[np.asarray(wanted) - lo]
        raise TypeError("lazy FITS HDU supports only int/slice indexing "
                        "along the frame axis")


def byteswap_array(array):
    """Return the array byteswapped with flipped byte-order dtype
    (reference fits.py:149-179)."""
    return array.byteswap().view(array.dtype.newbyteorder())


def info_fits(fitsfilename, **kwargs):
    """Print HDU layout of a FITS file (reference fits.py:182-196)."""
    hdus = _scan_hdus(str(fitsfilename))
    print("Filename: {}".format(fitsfilename))
    print("No.  Dimensions      BITPIX   Cards")
    for i, hdu in enumerate(hdus):
        print("{:3d}  {!s:15s} {:6d}   {:5d}".format(
            i, hdu["shape"], hdu["bitpix"], len(hdu["header"])))


def verify_fits(fitsfilename):
    """Verify basic FITS structure of one file or a list
    (reference fits.py:199-215)."""
    def _check(path):
        hdus = _scan_hdus(str(path))
        if not hdus:
            raise OSError("Empty or invalid FITS file: {}".format(path))
        first = hdus[0]["header"]
        if "SIMPLE" not in first:
            raise OSError("Missing SIMPLE card: {}".format(path))
    if isinstance(fitsfilename, list):
        for ffile in fitsfilename:
            _check(ffile)
    else:
        _check(fitsfilename)


def _write_hdu(fh, array, header, primary, precision):
    """Write one HDU (header blocks + padded big-endian data)."""
    h = Header()
    if primary:
        h["SIMPLE"] = True
    else:
        h["XTENSION"] = "IMAGE"
    if array is None:
        h["BITPIX"] = 8
        h["NAXIS"] = 0
    else:
        bitpix = -32 if array.dtype == np.float32 else -64
        h["BITPIX"] = bitpix
        h["NAXIS"] = array.ndim
        for i, dim in enumerate(array.shape[::-1]):
            h["NAXIS{}".format(i + 1)] = int(dim)
    if not primary:
        h["PCOUNT"] = 0
        h["GCOUNT"] = 1
    if header is not None:
        items = header.items() if hasattr(header, "items") else header
        for k, v in items:
            ku = str(k).strip().upper()
            if ku in ("SIMPLE", "BITPIX", "NAXIS", "XTENSION", "PCOUNT",
                      "GCOUNT") or ku.startswith("NAXIS"):
                continue
            try:
                h[ku] = v
            except Exception:
                continue
        if isinstance(header, Header):
            h.comments_log += header.comments_log
            h.history_log += header.history_log

    cards = h.tocards()
    cards.append("END".ljust(CARD))
    text = "".join(cards)
    pad = (-len(text)) % BLOCK
    fh.write(text.encode("ascii") + b" " * pad)

    if array is not None:
        be = _native.encode(array)
        fh.write(be)
        fh.write(b"\x00" * ((-be.size) % BLOCK))


def write_fits(fitsfilename, array, header=None, output_verify="exception",
               precision=np.float32, verbose=True):
    """Write array(s) (+ header(s)) to a FITS file, replacing any existing
    file (reference fits.py:218-275). A tuple of arrays produces a
    multi-extension file."""
    if not fitsfilename.endswith(".fits"):
        fitsfilename += ".fits"
    res = "saved"
    if exists(fitsfilename):
        remove(fitsfilename)
        res = "overwritten"

    if isinstance(array, tuple):
        if header is None:
            header = [None] * len(array)
        elif not isinstance(header, tuple):
            header = [header] * len(array)
        elif len(header) != len(array):
            raise ValueError("If input header is a tuple, it should have "
                             "the same length as tuple of arrays.")
        with open(fitsfilename, "wb") as fh:
            # reference writes all-tuple input as (empty primary + image
            # extensions) via HDUList of ImageHDU; here first HDU is primary
            for i, arr in enumerate(array):
                arr = np.asarray(arr).astype(precision, copy=False)
                _write_hdu(fh, arr, header[i], primary=(i == 0),
                           precision=precision)
    else:
        array = np.asarray(array).astype(precision, copy=False)
        with open(fitsfilename, "wb") as fh:
            _write_hdu(fh, array, header, primary=True, precision=precision)
    if verbose:
        print("FITS file successfully {}".format(res))
