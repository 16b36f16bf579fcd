"""XTC trajectory I/O via the native C++ codec (ctypes binding).

The codec (``native/xtcio.cpp``) is a from-scratch implementation of the
GROMACS xdr3dfcoord format; this module builds it on demand with ``make``
and exposes numpy-level read/write. Coordinates are in nm (GROMACS
convention), shaped ``[n_frames, n_atoms, 3]``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libxtcio.so"
_lib: ctypes.CDLL | None = None


class XTCUnavailableError(RuntimeError):
    """Raised when the native codec cannot be built/loaded."""


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True,
                capture_output=True,
            )
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            raise XTCUnavailableError(f"could not build native XTC codec: {e}") from e
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:  # pragma: no cover
        raise XTCUnavailableError(str(e)) from e

    lib.xtc_scan.restype = ctypes.c_int
    lib.xtc_scan.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.xtc_read_frame.restype = ctypes.c_int
    lib.xtc_read_frame.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.xtc_write_frame.restype = ctypes.c_int
    lib.xtc_write_frame.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int32,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_float,
        ctypes.c_char_p,
        ctypes.c_int64,
    ]
    _lib = lib
    return lib


def read_xtc(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read an XTC file -> (coords [M, N, 3] nm, times [M], boxes [M, 3, 3])."""
    lib = _load()
    data = Path(path).read_bytes()
    natoms = ctypes.c_int32()
    nframes = lib.xtc_scan(data, len(data), ctypes.byref(natoms))
    if nframes < 0:
        raise ValueError(f"malformed XTC file: {path}")
    n = natoms.value
    coords = np.empty((nframes, n, 3), np.float32)
    times = np.empty((nframes,), np.float32)
    boxes = np.empty((nframes, 3, 3), np.float32)
    offset = ctypes.c_int64(0)
    frame = np.empty((n * 3,), np.float32)
    box = np.empty((9,), np.float32)
    step = ctypes.c_int32()
    t = ctypes.c_float()
    for m in range(nframes):
        ret = lib.xtc_read_frame(
            data,
            len(data),
            ctypes.byref(offset),
            frame.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n,
            box.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(step),
            ctypes.byref(t),
        )
        if ret != n:
            raise ValueError(f"XTC decode error in frame {m} of {path} (ret={ret})")
        coords[m] = frame.reshape(n, 3)
        times[m] = t.value
        boxes[m] = box.reshape(3, 3)
    return coords, times, boxes


def write_xtc(
    path: str,
    coords: np.ndarray,
    times: np.ndarray | None = None,
    precision: float = 1000.0,
) -> None:
    """Write coords ``[M, N, 3]`` (nm) as an XTC file."""
    lib = _load()
    coords = np.ascontiguousarray(coords, np.float32)
    M, N, _ = coords.shape
    if times is None:
        times = np.arange(M, dtype=np.float32)
    box = np.zeros((9,), np.float32)
    cap = N * 3 * 4 + 1024
    out = ctypes.create_string_buffer(cap)
    with open(path, "wb") as f:
        for m in range(M):
            nb = lib.xtc_write_frame(
                coords[m].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                N,
                m,
                float(times[m]),
                box.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                precision,
                out,
                cap,
            )
            if nb < 0:
                raise ValueError(f"XTC encode error in frame {m}")
            f.write(out.raw[:nb])
