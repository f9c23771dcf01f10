"""ctypes bindings for the native channel-bank ring (native/pskbank.cpp).

The bank is the host-side deframing stage for batched demod: producers push
sample-interleaved multichannel frames (a channelizer's natural output
order, and the demod-batch CLI's input format); the consumer pops
channel-major (C, n) complex64 blocks sized for the device step.  The
strided deinterleave runs in C++ concurrently with the engine's device
dispatch, replacing C per-channel numpy slice-copies per chunk.

Overflow semantics mirror the native packet queue (and the reference's
BulkIO queue, cpp/psk_soft.cpp:353-357): a push that would overflow drops
everything queued and flags the next popped block, which the engine answers
with a state reset.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libpskbank.so"))

_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            subprocess.run(["make", "-C", os.path.dirname(_LIB_PATH)],
                           check=True, capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.pskbank_create.restype = ctypes.c_void_p
        lib.pskbank_create.argtypes = [ctypes.c_int32, ctypes.c_int64]
        lib.pskbank_destroy.argtypes = [ctypes.c_void_p]
        lib.pskbank_push_interleaved.restype = ctypes.c_int
        lib.pskbank_push_interleaved.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.pskbank_available.restype = ctypes.c_int64
        lib.pskbank_available.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.pskbank_pop_block.restype = ctypes.c_int64
        lib.pskbank_pop_block.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]
        lib.pskbank_close.argtypes = [ctypes.c_void_p]
        lib.pskbank_depth.restype = ctypes.c_int64
        lib.pskbank_depth.argtypes = [ctypes.c_void_p]
        lib.pskbank_stats.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_uint64)]
        lib.pskplane_create.restype = ctypes.c_void_p
        lib.pskplane_create.argtypes = [ctypes.c_int32, ctypes.c_int64,
                                        ctypes.c_int32]
        lib.pskplane_destroy.argtypes = [ctypes.c_void_p]
        lib.pskplane_push_interleaved.restype = ctypes.c_int
        lib.pskplane_push_interleaved.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.pskplane_available.restype = ctypes.c_int64
        lib.pskplane_available.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.pskplane_pop_planes.restype = ctypes.c_int64
        lib.pskplane_pop_planes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
        lib.pskplane_close.argtypes = [ctypes.c_void_p]
        lib.pskplane_depth.restype = ctypes.c_int64
        lib.pskplane_depth.argtypes = [ctypes.c_void_p]
        lib.pskplane_stats.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_uint64)]
        _lib = lib
        return lib


@dataclasses.dataclass
class BankStats:
    frames_in: int
    samples_out: int
    flushes: int
    dropped_samples: int


class NativeChannelBank:
    """Bounded lockstep multichannel ring with native deinterleave.

    ``capacity_samples`` bounds the queued depth per channel; a push that
    would exceed it flushes the ring (overflow => accepted data loss) and
    the next :meth:`pop_block` reports ``flushed=True``.
    """

    def __init__(self, channels: int, capacity_samples: int = 1 << 20):
        self._lib = _load_lib()
        self.channels = int(channels)
        self._h = self._lib.pskbank_create(self.channels,
                                           int(capacity_samples))
        if not self._h:
            raise ValueError("pskbank_create failed (bad channels/capacity)")

    def push_interleaved(self, frames: np.ndarray) -> bool:
        """Push sample-interleaved complex64 data: shape (n, C), (n*C,), or
        raw float32 of length 2*n*C.  Returns True if this push triggered an
        overflow flush."""
        arr = np.asarray(frames)
        if np.iscomplexobj(arr):
            arr = arr.astype(np.complex64, copy=False).view(np.float32)
        arr = np.ascontiguousarray(arr, np.float32).ravel()
        if arr.size % (2 * self.channels):
            raise ValueError(
                f"push must be whole frames of {self.channels} channels")
        n_frames = arr.size // (2 * self.channels)
        rc = self._lib.pskbank_push_interleaved(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_frames)
        if rc < 0:
            raise RuntimeError(f"pskbank_push_interleaved failed: {rc}")
        return bool(rc)

    def pop_block(self, n: int, timeout: Optional[float] = None):
        """Blocking pop of a channel-major (C, n) complex64 block.

        Returns ``(block, flushed)`` or ``None`` on timeout.  ``flushed``
        reports (and clears) the overflow marker set since the last pop.
        """
        timeout_ms = -1 if timeout is None else max(0, int(timeout * 1000))
        avail = self._lib.pskbank_available(self._h, int(n), timeout_ms)
        if avail < n:
            return None
        out = np.empty((self.channels, n), np.complex64)
        flushed = ctypes.c_int32()
        rc = self._lib.pskbank_pop_block(
            self._h, out.view(np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)),
            int(n), ctypes.byref(flushed))
        if rc < 0:
            return None     # raced with a concurrent consumer's pop
        return out, bool(flushed.value)

    def close(self) -> None:
        self._lib.pskbank_close(self._h)

    def depth(self) -> int:
        return int(self._lib.pskbank_depth(self._h))

    def stats(self) -> BankStats:
        out = (ctypes.c_uint64 * 4)()
        self._lib.pskbank_stats(self._h, out)
        return BankStats(*[int(v) for v in out])

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.pskbank_destroy(self._h)
                self._h = None
        except Exception:
            pass


class NativePlaneBank:
    """Lockstep multichannel ring that deframes straight to TIME-MAJOR
    re/im planes -- the steady step's (T, C) input layout.

    Interleaved frames are already time-major across channels, so the
    native stage is a stride-2 re/im split (no transpose), and a pop is two
    contiguous memcpys; the per-block host transposes of the channel-major
    path (engine x.real.T copies) disappear.  ``dtype`` selects the wire
    format: "f32" (complex64 frames) or "i16" (int16 I/Q, half the bytes --
    pairs with the steady step's int16 ingest mode).

    Overflow semantics match :class:`NativeChannelBank` (flush + flag).
    """

    def __init__(self, channels: int, capacity_samples: int = 1 << 20,
                 dtype: str = "f32"):
        if dtype not in ("f32", "i16"):
            raise ValueError(f"dtype must be 'f32' or 'i16', got {dtype!r}")
        self._lib = _load_lib()
        self.channels = int(channels)
        self.dtype = dtype
        self._np_dtype = np.float32 if dtype == "f32" else np.int16
        self._h = self._lib.pskplane_create(
            self.channels, int(capacity_samples),
            4 if dtype == "f32" else 2)
        if not self._h:
            raise ValueError("pskplane_create failed (bad args)")

    def push_interleaved(self, frames: np.ndarray) -> bool:
        """Push interleaved frames: complex64 (f32 mode) or flat pairs of
        the wire dtype, length 2*n*C.  Returns True on overflow flush."""
        arr = np.asarray(frames)
        if np.iscomplexobj(arr):
            if self.dtype != "f32":
                raise ValueError("i16 bank takes int16 I/Q pairs")
            arr = arr.astype(np.complex64, copy=False).view(np.float32)
        arr = np.ascontiguousarray(arr, self._np_dtype).ravel()
        if arr.size % (2 * self.channels):
            raise ValueError(
                f"push must be whole frames of {self.channels} channels")
        n_frames = arr.size // (2 * self.channels)
        rc = self._lib.pskplane_push_interleaved(
            self._h, arr.ctypes.data_as(ctypes.c_void_p), n_frames)
        if rc < 0:
            raise RuntimeError(f"pskplane_push_interleaved failed: {rc}")
        return bool(rc)

    def pop_planes(self, n: int, timeout: Optional[float] = None):
        """Blocking pop of ``(re, im, flushed)`` with (n, C) plane arrays of
        the wire dtype, ready for device upload.  None on timeout."""
        timeout_ms = -1 if timeout is None else max(0, int(timeout * 1000))
        avail = self._lib.pskplane_available(self._h, int(n), timeout_ms)
        if avail < n:
            return None
        re = np.empty((n, self.channels), self._np_dtype)
        im = np.empty((n, self.channels), self._np_dtype)
        flushed = ctypes.c_int32()
        rc = self._lib.pskplane_pop_planes(
            self._h, re.ctypes.data_as(ctypes.c_void_p),
            im.ctypes.data_as(ctypes.c_void_p), int(n),
            ctypes.byref(flushed))
        if rc < 0:
            return None     # raced with a concurrent consumer's pop
        return re, im, bool(flushed.value)

    def close(self) -> None:
        self._lib.pskplane_close(self._h)

    def depth(self) -> int:
        return int(self._lib.pskplane_depth(self._h))

    def stats(self) -> BankStats:
        out = (ctypes.c_uint64 * 4)()
        self._lib.pskplane_stats(self._h, out)
        return BankStats(*[int(v) for v in out])

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.pskplane_destroy(self._h)
                self._h = None
        except Exception:
            pass
