"""Minimal ONNX protobuf writer/reader (wire format, no deps).

The environment has no ``onnx`` package; ONNX files are ordinary protobufs,
so this module emits them directly (role of the onnx lib's ``make_model`` /
``make_node`` helpers used by the reference's mx2onnx exporter,
python/mxnet/onnx/mx2onnx/_export_onnx.py). Field numbers follow onnx.proto3
(IR version 8 / opset 17 era). Repeated scalars are emitted unpacked, which
every conforming protobuf parser accepts.

A small decoder (`parse_message`) exists for round-trip testing.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple, Union

# ---------------------------------------------------------------- writer

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's complement for negatives
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def f_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(int(value))


def f_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(value))


def f_bytes(field: int, value: Union[bytes, str]) -> bytes:
    if isinstance(value, str):
        value = value.encode("utf-8")
    return _tag(field, 2) + _varint(len(value)) + value


f_string = f_bytes
f_message = f_bytes  # a submessage is length-delimited encoded bytes


# ONNX enums (onnx.proto3)
class DataType:
    FLOAT = 1
    UINT8 = 2
    INT8 = 3
    INT16 = 5
    INT32 = 6
    INT64 = 7
    BOOL = 9
    FLOAT16 = 10
    DOUBLE = 11
    BFLOAT16 = 16


class AttrType:
    FLOAT = 1
    INT = 2
    STRING = 3
    TENSOR = 4
    FLOATS = 6
    INTS = 7
    STRINGS = 8


_NP_TO_ONNX = {
    "float32": DataType.FLOAT, "float64": DataType.DOUBLE,
    "float16": DataType.FLOAT16, "bfloat16": DataType.BFLOAT16,
    "int8": DataType.INT8, "uint8": DataType.UINT8,
    "int32": DataType.INT32, "int64": DataType.INT64,
    "bool": DataType.BOOL, "int16": DataType.INT16,
}


def np_dtype_to_onnx(dtype) -> int:
    import numpy as onp
    key = str(onp.dtype(dtype))
    if key not in _NP_TO_ONNX:
        raise ValueError(f"no ONNX data type for {dtype}")
    return _NP_TO_ONNX[key]


def make_tensor(name: str, array) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    import numpy as onp
    arr = onp.ascontiguousarray(array)
    out = b"".join(f_varint(1, d) for d in arr.shape)
    out += f_varint(2, np_dtype_to_onnx(arr.dtype))
    out += f_string(8, name)
    out += f_bytes(9, arr.tobytes())
    return out


def make_attr(name: str, value) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20."""
    out = f_string(1, name)
    if isinstance(value, bool):
        out += f_varint(3, int(value)) + f_varint(20, AttrType.INT)
    elif isinstance(value, int):
        out += f_varint(3, value) + f_varint(20, AttrType.INT)
    elif isinstance(value, float):
        out += f_float(2, value) + f_varint(20, AttrType.FLOAT)
    elif isinstance(value, (str, bytes)):
        out += f_bytes(4, value) + f_varint(20, AttrType.STRING)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, int) for v in value):
            out += b"".join(f_varint(8, v) for v in value)
            out += f_varint(20, AttrType.INTS)
        elif all(isinstance(v, (int, float)) for v in value):
            out += b"".join(f_float(7, float(v)) for v in value)
            out += f_varint(20, AttrType.FLOATS)
        else:
            raise ValueError(f"unsupported attribute list {name}={value!r}")
    elif hasattr(value, "shape"):  # tensor attribute
        out += f_message(5, make_tensor(name + "_value", value))
        out += f_varint(20, AttrType.TENSOR)
    else:
        raise ValueError(f"unsupported attribute {name}={value!r}")
    return out


def make_node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
              name: str = "", **attrs) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    out = b"".join(f_string(1, i) for i in inputs)
    out += b"".join(f_string(2, o) for o in outputs)
    if name:
        out += f_string(3, name)
    out += f_string(4, op_type)
    for k in sorted(attrs):
        if attrs[k] is None:
            continue
        out += f_message(5, make_attr(k, attrs[k]))
    return out


def make_value_info(name: str, dtype, shape=None) -> bytes:
    """ValueInfoProto: name=1, type=2 → TypeProto.tensor_type=1 →
    {elem_type=1, shape=2 → dim=1 → {dim_value=1 | dim_param=2}}.
    ``shape=None`` omits the shape entirely (unknown rank — an empty
    TensorShapeProto would instead declare rank 0)."""
    tensor = f_varint(1, np_dtype_to_onnx(dtype))
    if shape is not None:
        dims = b""
        for d in shape:
            if isinstance(d, str):
                dims += f_message(1, f_string(2, d))
            else:
                dims += f_message(1, f_varint(1, int(d)))
        tensor += f_message(2, dims)
    return f_string(1, name) + f_message(2, f_message(1, tensor))


def make_graph(nodes: List[bytes], name: str, inputs: List[bytes],
               outputs: List[bytes], initializers: List[bytes]) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    out = b"".join(f_message(1, n) for n in nodes)
    out += f_string(2, name)
    out += b"".join(f_message(5, t) for t in initializers)
    out += b"".join(f_message(11, i) for i in inputs)
    out += b"".join(f_message(12, o) for o in outputs)
    return out


def make_model(graph: bytes, opset: int = 17,
               producer: str = "mxnet_tpu") -> bytes:
    """ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8."""
    out = f_varint(1, 8)  # IR version 8
    out += f_string(2, producer)
    out += f_message(7, graph)
    out += f_message(8, f_varint(2, opset))  # OperatorSetId: domain=1 (default ""), version=2
    return out


# ---------------------------------------------------------------- reader
# (for tests: structural decode, returns {field: [values]})

def parse_message(data: bytes) -> Dict[int, list]:
    out: Dict[int, list] = {}
    i = 0
    n = len(data)
    while i < n:
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(data, i)
        elif wire == 2:
            ln, i = _read_varint(data, i)
            v = data[i:i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack("<f", data[i:i + 4])[0]
            i += 4
        elif wire == 1:
            v = struct.unpack("<d", data[i:i + 8])[0]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(v)
    return out


def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = data[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
