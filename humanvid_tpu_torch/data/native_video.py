"""Python bindings of the native libav video core.

``VideoReader`` is decord's random-access API as the reference's datasets
use it (``reader[i]``, ``get_batch(indices)``); ``VideoWriter`` is its
PyAV x264 save (crf 19). Both are ``ctypes`` wrappers over
``humanvid_tpu_torch/native/videodec.cpp``; decode and encode run in C with
the GIL released, so thread-pool loaders scale. The port's copy of the JAX
package's bindings.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

from ..native import available as native_available, load_library


class VideoReader:
    """Random-access frame reader: ``reader[i]``, ``reader.get_batch(idxs)``."""

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self._lib = load_library()
        self._h = self._lib.hvt_vd_open(path.encode())
        if not self._h:
            raise IOError(
                f"cannot open video {path}: {self._lib.hvt_last_error().decode()}"
            )
        self.width = self._lib.hvt_vd_width(self._h)
        self.height = self._lib.hvt_vd_height(self._h)
        self.fps = self._lib.hvt_vd_fps(self._h)
        self._len = self._lib.hvt_vd_frames(self._h)

    def __len__(self) -> int:
        return int(self._len)

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        """Decode frames by index -> (n, H, W, 3) RGB uint8."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        n = idx.shape[0]
        out = np.empty((n, self.height, self.width, 3), np.uint8)
        ok = self._lib.hvt_vd_read(
            self._h,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if not ok:
            raise IOError(f"decode failed: {self._lib.hvt_last_error().decode()}")
        return out

    def __getitem__(self, i: int) -> np.ndarray:
        return self.get_batch([i])[0]

    def read_all(self, max_frames: Optional[int] = None) -> np.ndarray:
        n = len(self) if max_frames is None else min(len(self), max_frames)
        return self.get_batch(np.arange(n))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.hvt_vd_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class VideoWriter:
    """Streaming mp4 writer (H.264 crf when available, else MPEG4)."""

    def __init__(self, path: str, width: int, height: int, fps: float = 24.0,
                 crf: int = 19):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lib = load_library()
        self._h = self._lib.hvt_ve_open(path.encode(), width, height, fps, crf)
        if not self._h:
            raise IOError(
                f"cannot open encoder {path}: {self._lib.hvt_last_error().decode()}"
            )
        self.width, self.height = width, height

    def write(self, frames: np.ndarray) -> None:
        """(H, W, 3) or (n, H, W, 3) RGB uint8 (float in [0,1] accepted)."""
        if frames.ndim == 3:
            frames = frames[None]
        if frames.dtype != np.uint8:
            frames = (np.clip(frames, 0.0, 1.0) * 255).astype(np.uint8)
        assert frames.shape[1:] == (self.height, self.width, 3), frames.shape
        frames = np.ascontiguousarray(frames)
        ok = self._lib.hvt_ve_write(
            self._h,
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            frames.shape[0],
        )
        if not ok:
            raise IOError(f"encode failed: {self._lib.hvt_last_error().decode()}")

    def close(self) -> None:
        if getattr(self, "_h", None):
            if not self._lib.hvt_ve_close(self._h):
                self._h = None
                raise IOError(f"finalize failed: {self._lib.hvt_last_error().decode()}")
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["VideoReader", "VideoWriter", "native_available"]
