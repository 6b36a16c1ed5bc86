"""A reader of flax's ``.msgpack`` parameter trees, in pure Python.

``flax.serialization.to_bytes`` / ``msgpack_serialize`` write a tree of
maps with string keys whose leaves are arrays (msgpack ExtType 1: a msgpack
array of the shape, the dtype's name and the C-order bytes), numpy scalars
(ExtType 3, the same encoding), complex numbers (ExtType 2: real and
imaginary parts) and plain msgpack values; an array above 2**30 bytes is
split into ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks":
...}``. This module decodes that subset of msgpack (maps, arrays, strings,
binaries, ints, floats, booleans, nil and extension types) without the
``msgpack`` or ``flax`` packages, and returns nested dicts of numpy arrays,
as flax's ``msgpack_restore`` does. ``bfloat16`` leaves, which numpy has no
dtype for, are widened exactly to float32.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width values: code -> struct format
_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def length(self, nbytes: int) -> int:
        return self.unpack(_LEN[nbytes])

    def value(self) -> Any:
        code = self.unpack(">B")
        if code <= 0x7f:
            return code
        if code >= 0xe0:
            return code - 0x100
        if 0x80 <= code <= 0x8f:
            return self.map(code & 0x0f)
        if 0x90 <= code <= 0x9f:
            return self.array(code & 0x0f)
        if 0xa0 <= code <= 0xbf:
            return str(self.take(code & 0x1f), "utf-8")
        if code == 0xc0:
            return None
        if code in (0xc2, 0xc3):
            return code == 0xc3
        if code in _FIXED:
            return self.unpack(_FIXED[code])
        if 0xc4 <= code <= 0xc6:  # bin 8/16/32
            return bytes(self.take(self.length(1 << (code - 0xc4))))
        if 0xc7 <= code <= 0xc9:  # ext 8/16/32
            n = self.length(1 << (code - 0xc7))
            return self.ext(self.unpack(">b"), n)
        if 0xd4 <= code <= 0xd8:  # fixext 1/2/4/8/16
            return self.ext(self.unpack(">b"), 1 << (code - 0xd4))
        if 0xd9 <= code <= 0xdb:  # str 8/16/32
            return str(self.take(self.length(1 << (code - 0xd9))), "utf-8")
        if code in (0xdc, 0xdd):
            return self.array(self.length(2 if code == 0xdc else 4))
        if code in (0xde, 0xdf):
            return self.map(self.length(2 if code == 0xde else 4))
        raise ValueError(f"unsupported msgpack type code 0x{code:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, kind: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if kind == _EXT_NDARRAY:
            return _ndarray(payload)
        if kind == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if kind == _EXT_COMPLEX:
            real, imag = _Reader(payload).value()
            return complex(real, imag)
        raise ValueError(f"unsupported msgpack extension type {kind}")


def _dtype(name: str) -> Tuple[np.dtype, bool]:
    """(numpy dtype of the stored bytes, whether they are bfloat16)."""
    if name == "bfloat16":
        return np.dtype("<u2"), True
    return np.dtype(name), False


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buffer = _Reader(payload).value()
    dtype, bf16 = _dtype(name if isinstance(name, str) else name.decode())
    arr = np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()
    if bf16:  # the top half of a float32
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """The tree that flax's ``msgpack_serialize`` encoded in ``data``."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after the tree")
    return _unchunk(tree)


def load_msgpack(path: str) -> Any:
    """A flax ``.msgpack`` file's tree: nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
