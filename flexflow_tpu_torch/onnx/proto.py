"""Self-contained ONNX ModelProto reader and writer.

The port's copy of ``flexflow_tpu/onnx/proto.py``. It speaks the protobuf
wire format directly for the subset of onnx.proto3 the frontend needs
(ModelProto -> GraphProto -> NodeProto / AttributeProto / TensorProto /
ValueInfoProto), so real ``.onnx`` files (e.g. ``torch.onnx.export``
output) parse with no third-party package; where the ``onnx`` package is
importable the frontend still accepts its protos, which duck-type the
classes here. The writer (``encode_model`` / ``encode_node``) makes the
files the tests and ``chip_smoke.py`` import.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# TensorProto.DataType → numpy
TENSOR_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}

# ---- wire-format primitives ----------------------------------------------


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(data: bytes):
    """Yield (field_number, wire_type, value) triples of one message.
    value: int for varint/fixed, bytes for length-delimited."""
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v, pos = _read_varint(data, pos)
        elif wt == 1:  # fixed64
            v = struct.unpack_from("<Q", data, pos)[0]
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(data, pos)
            v = data[pos:pos + ln]
            pos += ln
        elif wt == 5:  # fixed32
            v = struct.unpack_from("<I", data, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _packed_varints(v, wt) -> List[int]:
    if wt == 0:
        return [v]
    out, pos = [], 0
    while pos < len(v):
        x, pos = _read_varint(v, pos)
        out.append(x)
    return out


def _zigzag64(v: int) -> int:
    """Interpret a 64-bit varint as two's-complement signed."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---- proto classes (duck-type the onnx package's) -------------------------


class TensorProto:
    def __init__(self):
        self.dims: List[int] = []
        self.data_type: int = 1
        self.name: str = ""
        self.raw_data: bytes = b""
        self.float_data: List[float] = []
        self.int32_data: List[int] = []
        self.int64_data: List[int] = []
        self.double_data: List[float] = []

    @classmethod
    def parse(cls, data: bytes) -> "TensorProto":
        t = cls()
        for field, wt, v in _fields(data):
            if field == 1:
                t.dims.extend(_zigzag64(x) for x in _packed_varints(v, wt))
            elif field == 2:
                t.data_type = v
            elif field == 4:
                if wt == 5:
                    t.float_data.append(
                        struct.unpack("<f", struct.pack("<I", v))[0])
                else:
                    t.float_data.extend(
                        struct.unpack(f"<{len(v) // 4}f", v))
            elif field == 5:
                t.int32_data.extend(_packed_varints(v, wt))
            elif field == 7:
                t.int64_data.extend(
                    _zigzag64(x) for x in _packed_varints(v, wt))
            elif field == 8:
                t.name = v.decode()
            elif field == 9:
                t.raw_data = v
            elif field == 10:
                if wt == 1:
                    t.double_data.append(
                        struct.unpack("<d", struct.pack("<Q", v))[0])
                else:
                    t.double_data.extend(
                        struct.unpack(f"<{len(v) // 8}d", v))
        return t

    def to_numpy(self) -> np.ndarray:
        dtype = TENSOR_DTYPES.get(self.data_type, np.float32)
        shape = tuple(self.dims)
        if self.raw_data:
            return np.frombuffer(self.raw_data,
                                 dtype=dtype).reshape(shape).copy()
        for data in (self.float_data, self.int64_data, self.int32_data,
                     self.double_data):
            if data:
                return np.asarray(data, dtype=dtype).reshape(shape)
        return np.zeros(shape, dtype=dtype)


class AttributeProto:
    def __init__(self):
        self.name = ""
        self.type: Optional[int] = None
        self.f: Optional[float] = None
        self.i: Optional[int] = None
        self.s: Optional[bytes] = None
        self.t: Optional[TensorProto] = None
        self.floats: List[float] = []
        self.ints: List[int] = []

    @classmethod
    def parse(cls, data: bytes) -> "AttributeProto":
        a = cls()
        for field, wt, v in _fields(data):
            if field == 1:
                a.name = v.decode()
            elif field == 2:
                a.f = struct.unpack("<f", struct.pack("<I", v))[0]
            elif field == 3:
                a.i = _zigzag64(v)
            elif field == 4:
                a.s = v
            elif field == 5:
                a.t = TensorProto.parse(v)
            elif field == 7:
                if wt == 5:
                    a.floats.append(
                        struct.unpack("<f", struct.pack("<I", v))[0])
                else:
                    a.floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
            elif field == 8:
                a.ints.extend(_zigzag64(x) for x in _packed_varints(v, wt))
            elif field == 20:
                a.type = v
        return a


class NodeProto:
    def __init__(self):
        self.input: List[str] = []
        self.output: List[str] = []
        self.name = ""
        self.op_type = ""
        self.attribute: List[AttributeProto] = []

    @classmethod
    def parse(cls, data: bytes) -> "NodeProto":
        n = cls()
        for field, wt, v in _fields(data):
            if field == 1:
                n.input.append(v.decode())
            elif field == 2:
                n.output.append(v.decode())
            elif field == 3:
                n.name = v.decode()
            elif field == 4:
                n.op_type = v.decode()
            elif field == 5:
                n.attribute.append(AttributeProto.parse(v))
        return n


class ValueInfoProto:
    def __init__(self):
        self.name = ""
        self.elem_type: Optional[int] = None
        self.shape: Optional[List[Optional[int]]] = None

    @classmethod
    def parse(cls, data: bytes) -> "ValueInfoProto":
        vi = cls()
        for field, _, v in _fields(data):
            if field == 1:
                vi.name = v.decode()
            elif field == 2:  # TypeProto
                for f2, _, v2 in _fields(v):
                    if f2 != 1:  # tensor_type
                        continue
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:  # TensorShapeProto
                            dims: List[Optional[int]] = []
                            for f4, _, v4 in _fields(v3):
                                if f4 != 1:
                                    continue
                                dv: Optional[int] = None
                                for f5, _, v5 in _fields(v4):
                                    if f5 == 1:
                                        dv = v5
                                dims.append(dv)
                            vi.shape = dims
        return vi


class GraphProto:
    def __init__(self):
        self.node: List[NodeProto] = []
        self.name = ""
        self.initializer: List[TensorProto] = []
        self.input: List[ValueInfoProto] = []
        self.output: List[ValueInfoProto] = []

    @classmethod
    def parse(cls, data: bytes) -> "GraphProto":
        g = cls()
        for field, _, v in _fields(data):
            if field == 1:
                g.node.append(NodeProto.parse(v))
            elif field == 2:
                g.name = v.decode()
            elif field == 5:
                g.initializer.append(TensorProto.parse(v))
            elif field == 11:
                g.input.append(ValueInfoProto.parse(v))
            elif field == 12:
                g.output.append(ValueInfoProto.parse(v))
        return g


class ModelProto:
    def __init__(self):
        self.ir_version = 0
        self.graph = GraphProto()

    @classmethod
    def parse(cls, data: bytes) -> "ModelProto":
        m = cls()
        for field, _, v in _fields(data):
            if field == 1:
                m.ir_version = v
            elif field == 7:
                m.graph = GraphProto.parse(v)
        return m


def parse_model(data: bytes) -> ModelProto:
    return ModelProto.parse(data)


# ---- writer (tests build real wire-format models with it) -----------------


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    dtype_code = {v: k for k, v in TENSOR_DTYPES.items()}[arr.dtype.type]
    out = b""
    for d in arr.shape:
        out += _tag(1, 0) + _varint(d)
    out += _tag(2, 0) + _varint(dtype_code)
    out += _ld(8, name.encode())
    out += _ld(9, np.ascontiguousarray(arr).tobytes())
    return out


def encode_attribute(name: str, value: Any) -> bytes:
    out = _ld(1, name.encode())
    if isinstance(value, float):
        out += _tag(2, 5) + struct.pack("<f", value)
        out += _tag(20, 0) + _varint(1)
    elif isinstance(value, bool) or isinstance(value, int):
        out += _tag(3, 0) + _varint(int(value) & ((1 << 64) - 1))
        out += _tag(20, 0) + _varint(2)
    elif isinstance(value, (bytes, str)):
        out += _ld(4, value.encode() if isinstance(value, str) else value)
        out += _tag(20, 0) + _varint(3)
    elif isinstance(value, np.ndarray):
        out += _ld(5, encode_tensor(name, value))
        out += _tag(20, 0) + _varint(4)
    elif isinstance(value, (list, tuple)) and all(
            isinstance(x, int) for x in value):
        for x in value:
            out += _tag(8, 0) + _varint(int(x) & ((1 << 64) - 1))
        out += _tag(20, 0) + _varint(7)
    elif isinstance(value, (list, tuple)):
        for x in value:
            out += _tag(7, 5) + struct.pack("<f", float(x))
        out += _tag(20, 0) + _varint(6)
    else:
        raise TypeError(f"attribute {name}: {type(value)}")
    return out


def encode_node(op_type: str, inputs: List[str], outputs: List[str],
                name: str = "", **attrs) -> bytes:
    out = b""
    for i in inputs:
        out += _ld(1, i.encode())
    for o in outputs:
        out += _ld(2, o.encode())
    out += _ld(3, (name or outputs[0]).encode())
    out += _ld(4, op_type.encode())
    for k, v in attrs.items():
        out += _ld(5, encode_attribute(k, v))
    return out


def _encode_value_info(name: str, shape, elem_type: int = 1) -> bytes:
    dims = b""
    for d in shape:
        dims += _ld(1, _tag(1, 0) + _varint(d))
    tensor_type = _tag(1, 0) + _varint(elem_type) + _ld(2, dims)
    return _ld(1, name.encode()) + _ld(2, _ld(1, tensor_type))


def encode_model(nodes: List[bytes], initializers: Dict[str, np.ndarray],
                 inputs: Dict[str, tuple], outputs: Dict[str, tuple]) -> bytes:
    """Assemble ModelProto bytes from encode_node() payloads + named
    initializer arrays + graph input/output shapes."""
    g = b""
    for n in nodes:
        g += _ld(1, n)
    g += _ld(2, b"graph")
    for name, arr in initializers.items():
        g += _ld(5, encode_tensor(name, arr))
    for name, shape in inputs.items():
        g += _ld(11, _encode_value_info(name, shape))
    for name, shape in outputs.items():
        g += _ld(12, _encode_value_info(name, shape))
    return _tag(1, 0) + _varint(8) + _ld(7, g)  # ir_version 8 + graph
