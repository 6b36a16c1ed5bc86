"""Minimal ONNX initializer reader (no onnx or onnxruntime dependency).

The reference runs DWPose through onnxruntime with two downloaded ONNX files,
YOLOX-L person detection and the DWPose SimCC wholebody net. This module
parses the protobuf wire format directly to extract the graph initializers
(the weight tensors), which ``pose.yolox`` and ``pose.rtmpose`` load by their
upstream names. A copy of the JAX package's reader; it needs only numpy.

Only what weight extraction needs is implemented: ModelProto.graph(7) ->
GraphProto.initializer(5) -> TensorProto {dims(1), data_type(2), name(8),
raw_data(9), float_data(4), int64_data(7), int32_data(5)}.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

# TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt protobuf)")


def iter_fields(buf: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over one message's fields."""
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code = 1
    name = ""
    raw = None
    floats: List[bytes] = []
    int64s: List[int] = []
    int32s: List[int] = []
    for field, wire, val in iter_fields(buf):
        if field == 1:  # dims
            if wire == 0:
                dims.append(val)  # type: ignore[arg-type]
            else:  # packed
                p = 0
                mv = val  # type: ignore[assignment]
                while p < len(mv):
                    v, p = _read_varint(mv, p)
                    dims.append(v)
        elif field == 2 and wire == 0:
            dtype_code = val  # type: ignore[assignment]
        elif field == 8 and wire == 2:
            name = bytes(val).decode()  # type: ignore[arg-type]
        elif field == 9 and wire == 2:
            raw = bytes(val)  # type: ignore[arg-type]
        elif field == 4:  # float_data
            floats.append(bytes(val) if wire == 2 else val)  # type: ignore[arg-type]
        elif field == 7:  # int64_data
            if wire == 0:
                int64s.append(val)  # type: ignore[arg-type]
            else:
                p = 0
                while p < len(val):  # packed
                    v, p = _read_varint(val, p)
                    int64s.append(v)
        elif field == 5:  # int32_data
            if wire == 0:
                int32s.append(val)  # type: ignore[arg-type]
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int32s.append(v)
    np_dtype = _DTYPES.get(dtype_code, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.frombuffer(b"".join(
            f if isinstance(f, bytes) else struct.pack("<f", f) for f in floats
        ), dtype=np.float32)
    elif int64s:
        arr = np.asarray(int64s, np.int64)
    elif int32s:
        arr = np.asarray(int32s, np.int32)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr


def read_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """{initializer_name: ndarray} from an .onnx file."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    tensors: Dict[str, np.ndarray] = {}
    for field, wire, val in iter_fields(data):  # ModelProto
        if field == 7 and wire == 2:  # graph
            for gfield, gwire, gval in iter_fields(val):  # GraphProto
                if gfield == 5 and gwire == 2:  # initializer
                    name, arr = _parse_tensor(gval)
                    tensors[name] = arr
    return tensors
