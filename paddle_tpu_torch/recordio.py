"""RecordIO reader and writer over the port's native library (the port's
counterpart of paddle_tpu/recordio.py; reference: paddle/fluid/recordio/
and python/paddle/fluid/recordio_writer.py).

The chunked, CRC-checked, optionally zlib-compressed format lives in C++:
native/recordio.cc, the port's own copy of the JAX package's source, so a
file written by either package is byte for byte the other's and each
reads the other's. It is built by g++ at first use into
build/native/librecordio-<hash>.so beside the package, the hash taken
over the source, the flags, the compiler's version and the machine, and
bound with ctypes; nothing under paddle_tpu/ is built or loaded. A failed
build raises; there is no pure-Python fallback. On top of the records this
module layers the sample serialization readers use: each record is a
pickled sample.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pickle
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterable, Optional

__all__ = ["RecordIOWriter", "RecordIOScanner", "write_samples",
           "read_samples", "convert_reader_to_recordio_file", "library_path"]

_SOURCE = Path(__file__).resolve().parent / "native" / "recordio.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of this source, these flags, this compiler and
    this machine is built (a checkout copied to another machine builds
    its own)."""
    cxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout
    h = hashlib.sha256(_SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                       + cxx.encode() + platform.platform().encode())
    return BUILD_DIR / f"librecordio-{h.hexdigest()[:16]}.so"


def _build(lib: Path):
    """g++ the source into a temporary file beside `lib`, then rename it
    into place: processes building at once each write their own file, and
    a reader never sees half a library."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(_SOURCE),
                               "-lz"], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"building {_SOURCE} failed:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.recordio_writer_open.restype = ctypes.c_void_p
        lib.recordio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                             ctypes.c_int]
        lib.recordio_writer_write.restype = ctypes.c_int
        lib.recordio_writer_write.argtypes = [ctypes.c_void_p,
                                              ctypes.c_char_p, ctypes.c_int]
        lib.recordio_writer_close.restype = ctypes.c_int
        lib.recordio_writer_close.argtypes = [ctypes.c_void_p]
        lib.recordio_scanner_open.restype = ctypes.c_void_p
        lib.recordio_scanner_open.argtypes = [ctypes.c_char_p]
        lib.recordio_scanner_next.restype = ctypes.POINTER(ctypes.c_char)
        lib.recordio_scanner_next.argtypes = [ctypes.c_void_p,
                                              ctypes.POINTER(ctypes.c_int)]
        lib.recordio_scanner_error.restype = ctypes.c_int
        lib.recordio_scanner_error.argtypes = [ctypes.c_void_p]
        lib.recordio_scanner_close.restype = None
        lib.recordio_scanner_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class RecordIOWriter:
    """Appends records to a new file in chunks of about 1 MiB.
    `compressor`: "snappy" (the reference's name; zlib here, as in the JAX
    package) compresses each chunk, "none" stores it."""

    def __init__(self, path: str, compressor: str = "snappy",
                 max_num_records: int = 1000):
        lib = _load()
        comp = 0 if compressor in (None, "none", "no") else 1
        self._h = lib.recordio_writer_open(os.fsencode(path), comp, 1 << 20)
        if not self._h:
            raise IOError(f"cannot open {path} for writing")

    def write(self, data: bytes):
        if not self._h:
            raise ValueError("write to a closed RecordIOWriter")
        rc = _load().recordio_writer_write(self._h, data, len(data))
        if rc != 0:
            raise IOError("recordio write failed")

    def close(self):
        if self._h:
            rc = _load().recordio_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError("recordio close/flush failed")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordIOScanner:
    """Iterates the records of a file in order; a corrupted chunk (CRC
    mismatch, bad magic, truncation) raises IOError instead of ending the
    stream early."""

    def __init__(self, path: str):
        self._h = _load().recordio_scanner_open(os.fsencode(path))
        if not self._h:
            raise IOError(f"cannot open {path}")

    def __iter__(self):
        lib = _load()
        n = ctypes.c_int(0)
        while self._h:
            p = lib.recordio_scanner_next(self._h, ctypes.byref(n))
            if not p:
                if lib.recordio_scanner_error(self._h):
                    raise IOError(
                        "recordio stream ended on a corrupted chunk "
                        "(CRC mismatch, bad magic, or truncated file)")
                break
            yield ctypes.string_at(p, n.value)

    def close(self):
        if self._h:
            _load().recordio_scanner_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def write_samples(path: str, samples: Iterable, compressor="snappy"):
    """One pickled record per sample (the JAX package's protocol, so the
    bytes match)."""
    with RecordIOWriter(path, compressor) as w:
        for s in samples:
            w.write(pickle.dumps(s, protocol=pickle.HIGHEST_PROTOCOL))


def read_samples(path: str):
    """The samples of a file that `write_samples` (of either package)
    wrote. Unpickles: read only files this program's users wrote."""
    with RecordIOScanner(path) as s:
        for rec in s:
            yield pickle.loads(rec)


def convert_reader_to_recordio_file(filename, reader_creator,
                                    compressor="snappy", feeder=None):
    """The reference's recordio_writer.py API: write a reader's samples to
    a file; returns the file name."""
    write_samples(filename, reader_creator(), compressor)
    return filename
