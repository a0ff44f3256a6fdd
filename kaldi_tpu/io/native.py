"""ctypes bindings for the native ark I/O library (native/ark_io.cc).

(ref: the reference's table layer util/kaldi-table.h is C++; this is our
 equivalent native runtime component. Built on demand with g++; every
 entry point has a pure-Python fallback in kaldi_io.py.)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "ark_io.cc")
_SO = os.path.join(os.path.dirname(_SRC), "libkaldi_tpu_ark.so")


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if (not os.path.exists(_SO)
                or (os.path.exists(_SRC)
                    and os.path.getmtime(_SRC) > os.path.getmtime(_SO))):
            if not os.path.exists(_SRC):
                return None
            try:
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", _SO, _SRC],
                    check=True, capture_output=True, timeout=120)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.ark_open.restype = ctypes.c_void_p
        lib.ark_open.argtypes = [ctypes.c_char_p]
        lib.ark_next.restype = ctypes.c_int
        lib.ark_next.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.ark_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.ark_close.argtypes = [ctypes.c_void_p]
        lib.ark_create.restype = ctypes.c_void_p
        lib.ark_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.ark_write.restype = ctypes.c_int
        lib.ark_write.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
        lib.ark_close_writer.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def read_ark_native(path: str):
    """Yield (key, float32 array) from a binary FM/DM/FV/DV ark.
    Raises ValueError on entries the native reader can't parse (CM/text) —
    callers fall back to the Python reader."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native ark library unavailable")
    h = lib.ark_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    key = ctypes.create_string_buffer(1024)
    data = ctypes.POINTER(ctypes.c_float)()
    rows = ctypes.c_int()
    cols = ctypes.c_int()
    try:
        while True:
            rc = lib.ark_next(h, key, 1024, ctypes.byref(data),
                              ctypes.byref(rows), ctypes.byref(cols))
            if rc == 0:
                return
            if rc < 0:
                raise ValueError(f"native ark parse failure in {path} "
                                 f"(unsupported entry type?)")
            r, c = rows.value, cols.value
            n = (r if r > 0 else 1) * c
            arr = np.ctypeslib.as_array(data, shape=(n,)).copy()
            lib.ark_free(data)
            yield key.value.decode(), (arr.reshape(r, c) if r > 0 else arr)
    finally:
        lib.ark_close(h)


class ArkWriterNative:
    def __init__(self, path: str, scp_path: str | None = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native ark library unavailable")
        self._lib = lib
        self._h = lib.ark_create(path.encode(),
                                 (scp_path or "").encode())
        if not self._h:
            raise OSError(f"cannot create {path}")

    def write(self, key: str, value: np.ndarray):
        arr = np.ascontiguousarray(value, dtype=np.float32)
        rows, cols = (0, arr.shape[0]) if arr.ndim == 1 else arr.shape
        rc = self._lib.ark_write(
            self._h, key.encode(),
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols)
        if rc != 0:
            raise OSError("native ark write failed")

    def close(self):
        if self._h:
            self._lib.ark_close_writer(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
