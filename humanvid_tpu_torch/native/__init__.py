"""The host's native video core: libav decode and encode (``videodec.cpp``).

The port's copy of the JAX package's in-tree C++ core, which stands in for
decord's random-access decoder and PyAV's encoder, built against the
system's FFmpeg libraries and bound with ``ctypes``
(``humanvid_tpu_torch.data.native_video``).

``load_library()`` compiles the source at first use into ``build/`` at the
root of the checkout (ignored by git), under a name that carries a hash of
the source and the flags, so that an edited source is rebuilt. The compiler
writes a temporary file that is then renamed onto that name, so a process
never loads a library another is still writing. Where ``g++`` or the FFmpeg
development files are missing, it raises with the compiler's message; the
video facade then uses OpenCV.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "videodec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _target() -> Path:
    digest = hashlib.sha1(SRC.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()
    return BUILD_DIR / f"libhvt_video-{digest[:12]}.so"


def build() -> str:
    """Compile the shared library unless it is built; returns its path."""
    target = _target()
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as err:  # no compiler
            raise RuntimeError(f"{cmd[0]}: {err}") from err
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stderr.strip()}")
        os.replace(tmp, target)
    return str(target)


def load_library() -> ctypes.CDLL:
    """Build if needed and load the native library; raises (with the
    compiler's message) where it cannot, and keeps raising after that."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(f"native video library unavailable: {_build_error}")
        try:
            lib = ctypes.CDLL(build())
        except (RuntimeError, OSError) as err:
            _build_error = str(err)
            raise RuntimeError(f"native video library unavailable: {err}") from err

        c = ctypes
        lib.hvt_last_error.restype = c.c_char_p
        lib.hvt_vd_open.restype = c.c_void_p
        lib.hvt_vd_open.argtypes = [c.c_char_p]
        lib.hvt_vd_width.restype = c.c_int
        lib.hvt_vd_width.argtypes = [c.c_void_p]
        lib.hvt_vd_height.restype = c.c_int
        lib.hvt_vd_height.argtypes = [c.c_void_p]
        lib.hvt_vd_frames.restype = c.c_int64
        lib.hvt_vd_frames.argtypes = [c.c_void_p]
        lib.hvt_vd_fps.restype = c.c_double
        lib.hvt_vd_fps.argtypes = [c.c_void_p]
        lib.hvt_vd_read.restype = c.c_int
        lib.hvt_vd_read.argtypes = [
            c.c_void_p, c.POINTER(c.c_int64), c.c_int64, c.POINTER(c.c_uint8)
        ]
        lib.hvt_vd_close.argtypes = [c.c_void_p]
        lib.hvt_ve_open.restype = c.c_void_p
        lib.hvt_ve_open.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_double, c.c_int]
        lib.hvt_ve_write.restype = c.c_int
        lib.hvt_ve_write.argtypes = [c.c_void_p, c.POINTER(c.c_uint8), c.c_int64]
        lib.hvt_ve_close.restype = c.c_int
        lib.hvt_ve_close.argtypes = [c.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    try:
        load_library()
        return True
    except RuntimeError:
        return False
