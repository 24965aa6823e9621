"""ctypes bindings of the port's native host library
(``csrc/native_io.cpp``, its own copy of the JAX package's
``native/dsslam_native.cpp``): PGM/PPM decoding, the fused photometric +
geometric undistortion and the threaded prefetching stereo frame queue.

The library is host C++, built on first use with ``g++`` (the flags of
the JAX package's ``native/Makefile``) into ``build/torch_kernels/``,
named by a digest of its source, its flags and this host's CPU flags: it
is compiled with ``-march=native``, and a library built on a host with
other CPU features aborts elsewhere in the process, so another host builds
its own. Nothing here runs at import time, and nothing falls back: a
missing compiler or a failed build raises ``NativeUnavailable``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "native_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")


class NativeUnavailable(RuntimeError):
    pass


def _host_key() -> str:
    """This host's CPU feature flags (the library is built for them)."""
    with open("/proc/cpuinfo") as f:
        return next(l for l in f if l.startswith("flags"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    digest.update(_host_key().encode())
    return BUILD_DIR / f"libdsslam_native_io_{digest.hexdigest()[:16]}.so"


def build_native() -> str:
    """Compile the library for this host (once per source, flags and CPU
    flags) and return its path."""
    path = library_path()
    if path.exists():
        return str(path)
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise NativeUnavailable("no C++ compiler (g++) to build csrc/native_io.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeUnavailable(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)       # atomic: concurrent builders agree
    return str(path)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(build_native())
    lib.pnm_probe.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.pnm_probe.restype = ctypes.c_int
    lib.pnm_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.pnm_read.restype = ctypes.c_int
    F = ctypes.POINTER(ctypes.c_float)
    lib.undistort_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        F, F, F, F, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.undistort_u8.restype = None
    lib.queue_create.argtypes = [ctypes.c_int]
    lib.queue_create.restype = ctypes.c_void_p
    lib.queue_start.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        F, F, F, F, F, F,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.queue_start.restype = None
    lib.queue_pop.argtypes = [ctypes.c_void_p, F, F, ctypes.POINTER(ctypes.c_double),
                              ctypes.POINTER(ctypes.c_int)]
    lib.queue_pop.restype = ctypes.c_int
    lib.queue_destroy.argtypes = [ctypes.c_void_p]
    lib.queue_destroy.restype = None
    return lib


# the library's read codes (csrc/native_io.cpp)
READ_ERRORS = {-1: "cannot be opened", -2: "has no magic number", -3: "has a malformed header",
               -4: "is not P5/P6", -5: "is larger than the buffer", -6: "is truncated",
               -7: "is not an 8-bit P5 of the loader's in_size"}


def _fp(a: Optional[np.ndarray]):
    if a is None:
        return ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _lut(lut) -> Optional[np.ndarray]:
    """A photometric table of 256 floats (one per gray level), or None."""
    if lut is None:
        return None
    lut = np.ascontiguousarray(lut, np.float32)
    if lut.shape != (256,):
        raise ValueError(f"a LUT has 256 entries, got shape {lut.shape}")
    return lut


def read_pnm(path: str) -> np.ndarray:
    """A binary PGM (P5: [H, W]) or PPM (P6: [H, W, 3]) as uint8, byte for
    byte as the JAX package's reader gives it (a 16-bit P5 too: its first
    H x W bytes)."""
    lib = _lib()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.pnm_probe(path.encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c))
    if rc != 0:
        raise IOError(f"pnm_probe({path}) -> {rc}")
    out = np.empty(w.value * h.value * c.value, np.uint8)
    rc = lib.pnm_read(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      out.size)
    if rc != 0:
        raise IOError(f"pnm_read({path}) -> {rc}")
    if c.value == 1:
        return out.reshape(h.value, w.value)
    return out.reshape(h.value, w.value, 3)


def undistort(src_u8: np.ndarray, map_x: Optional[np.ndarray],
              map_y: Optional[np.ndarray], lut: Optional[np.ndarray] = None,
              n_threads: int = 4) -> np.ndarray:
    """Fused LUT + bilinear remap; identity maps -> pass map_x=map_y=None."""
    lib = _lib()
    src = np.ascontiguousarray(src_u8, np.uint8)
    in_h, in_w = src.shape
    if map_x is None:
        ys, xs = np.mgrid[0:in_h, 0:in_w].astype(np.float32)
        map_x, map_y = xs, ys
    map_x = np.ascontiguousarray(map_x, np.float32)
    map_y = np.ascontiguousarray(map_y, np.float32)
    if map_x.ndim != 2 or map_y.shape != map_x.shape:
        raise ValueError(f"undistort: maps [h, w] of one shape, got {map_x.shape}, {map_y.shape}")
    out_h, out_w = map_x.shape
    out = np.empty((out_h, out_w), np.float32)
    lut_c = _lut(lut)
    lib.undistort_u8(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), in_w, in_h,
        _fp(lut_c), _fp(map_x), _fp(map_y), _fp(out), out_w, out_h, n_threads)
    return out


class NativeStereoLoader:
    """Threaded prefetching stereo frame loader over PGM file lists: a
    worker thread reads, remaps and queues up to ``capacity`` pairs ahead
    of the consumer. Yields the dataset dicts (``img0``, ``img1`` float32
    [out_h, out_w], ``timestamp``, ``incoming_id``). The files are 8-bit
    P5 of ``in_size``; a pair that cannot be read, or whose image is not
    such a file, raises ``IOError`` once the pairs before it are consumed;
    ``close()`` stops and joins the worker."""

    def __init__(self, files0: List[str], files1: List[str],
                 timestamps: List[float],
                 in_size: Tuple[int, int], out_size: Tuple[int, int],
                 map_x0=None, map_y0=None, map_x1=None, map_y1=None,
                 lut0=None, lut1=None, capacity: int = 8, n_threads: int = 4):
        lib = _lib()
        self._lib = lib
        self._h = None
        in_w, in_h = in_size
        out_w, out_h = out_size
        if map_x0 is None:
            ys, xs = np.mgrid[0:out_h, 0:out_w].astype(np.float32)
            map_x0, map_y0 = xs.copy(), ys.copy()
        if map_x1 is None:
            map_x1, map_y1 = map_x0, map_y0
        if not len(files0) == len(files1) == len(timestamps):
            raise ValueError(f"{len(files0)} left files, {len(files1)} right, "
                             f"{len(timestamps)} timestamps")
        # buffers the worker reads while it runs
        self._keep = [np.ascontiguousarray(a, np.float32)
                      for a in (map_x0, map_y0, map_x1, map_y1)] + [_lut(lut0), _lut(lut1)]
        if any(m.shape != (out_h, out_w) for m in self._keep[:4]):
            raise ValueError(f"the maps must be [{out_h}, {out_w}] (out_size), got "
                             f"{[m.shape for m in self._keep[:4]]}")
        self.files0 = list(files0)
        self.out_w, self.out_h = out_w, out_h
        self.n = len(files0)
        stamps = np.asarray(timestamps, np.float64)
        self._h = lib.queue_create(capacity)
        lib.queue_start(
            self._h, "\n".join(files0).encode(), "\n".join(files1).encode(),
            stamps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), self.n,
            _fp(self._keep[4]), _fp(self._keep[5]),
            _fp(self._keep[0]), _fp(self._keep[1]),
            _fp(self._keep[2]), _fp(self._keep[3]),
            in_w, in_h, out_w, out_h, n_threads)

    def __iter__(self):
        while True:
            img0 = np.empty((self.out_h, self.out_w), np.float32)
            img1 = np.empty((self.out_h, self.out_w), np.float32)
            ts = ctypes.c_double()
            fid = ctypes.c_int()
            rc = self._lib.queue_pop(self._h, _fp(img0), _fp(img1),
                                     ctypes.byref(ts), ctypes.byref(fid))
            if rc == 0:
                return
            if rc < 0:
                raise IOError(f"NativeStereoLoader: pair {fid.value} "
                              f"({self.files0[fid.value]}) could not be read: an image "
                              f"{READ_ERRORS.get(rc, 'failed')} ({rc})")
            yield {"img0": img0, "img1": img1, "timestamp": ts.value,
                   "incoming_id": fid.value}

    def close(self):
        if self._h:
            self._lib.queue_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
