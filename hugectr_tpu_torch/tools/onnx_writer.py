"""Dependency-free ONNX model writer.

Analog of the reference onnx_converter (onnx_converter/hugectr2onnx/
graph_builder.py) WITHOUT requiring the `onnx` package: emits ONNX
ModelProto files by encoding the protobuf wire format directly (the ONNX
schema's field numbers are stable public API). Covers the subset needed for
CTR inference graphs: nodes, float/int64 initializers, tensor value infos,
opset imports.

Wire-format encoder: protobuf = sequence of (tag, payload); tag =
(field_number << 3) | wire_type; wire types: 0=varint, 2=length-delimited.

The port's own copy of hugectr_tpu/tools/onnx_writer.py (numpy only, no torch), kept so that
the port imports nothing of the JAX package; its outputs are the JAX
module's, byte for byte.
"""
from __future__ import annotations

import struct
from typing import List, Sequence, Tuple, Union

import numpy as np

# ---------------------------------------------------------------- encoder
def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
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


def _field_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _field_bytes(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _field_str(field: int, s: str) -> bytes:
    return _field_bytes(field, s.encode("utf-8"))


# ONNX TensorProto.DataType values
FLOAT = 1
INT32 = 6
INT64 = 7
BOOL = 9

_NP2ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
}


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = np.ascontiguousarray(arr)
    out = b""
    for d in arr.shape:
        out += _field_varint(1, int(d))
    out += _field_varint(2, _NP2ONNX[arr.dtype])
    out += _field_str(8, name)
    out += _field_bytes(9, arr.tobytes())
    return out


def _tensor_shape(dims: Sequence[Union[int, str]]) -> bytes:
    """TensorShapeProto: repeated Dimension(dim_value=1 | dim_param=3)."""
    out = b""
    for d in dims:
        if isinstance(d, str):
            dim = _field_str(3, d)
        else:
            dim = _field_varint(1, int(d))
        out += _field_bytes(1, dim)
    return out


def value_info(name: str, elem_type: int, dims: Sequence[Union[int, str]]) -> bytes:
    """ValueInfoProto: name=1, type=2{tensor_type=1{elem_type=1, shape=2}}."""
    tt = _field_varint(1, elem_type) + _field_bytes(2, _tensor_shape(dims))
    tp = _field_bytes(1, tt)
    return _field_str(1, name) + _field_bytes(2, tp)


# AttributeProto.AttributeType
_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_TENSOR = 1, 2, 3, 4
_ATTR_FLOATS, _ATTR_INTS, _ATTR_STRINGS = 6, 7, 8


def _attribute(name: str, value) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20."""
    out = _field_str(1, name)
    if isinstance(value, bool):
        out += _field_varint(3, int(value)) + _field_varint(20, _ATTR_INT)
    elif isinstance(value, int):
        out += _field_varint(3, value) + _field_varint(20, _ATTR_INT)
    elif isinstance(value, float):
        out += _tag(2, 5) + struct.pack("<f", value) + _field_varint(20, _ATTR_FLOAT)
    elif isinstance(value, str):
        out += _field_bytes(4, value.encode()) + _field_varint(20, _ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += _field_bytes(5, tensor_proto(name + "_t", value))
        out += _field_varint(20, _ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, int) for v in value):
            for v in value:
                out += _field_varint(8, v)
            out += _field_varint(20, _ATTR_INTS)
        elif all(isinstance(v, float) for v in value):
            for v in value:
                out += _tag(7, 5) + struct.pack("<f", v)
            out += _field_varint(20, _ATTR_FLOATS)
        else:
            raise TypeError(f"attribute list {name}: {value}")
    else:
        raise TypeError(f"attribute {name}: {type(value)}")
    return out


def node_proto(
    op_type: str,
    inputs: Sequence[str],
    outputs: Sequence[str],
    name: str = "",
    **attrs,
) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    out = b""
    for i in inputs:
        out += _field_str(1, i)
    for o in outputs:
        out += _field_str(2, o)
    out += _field_str(3, name or f"{op_type}_{outputs[0]}")
    out += _field_str(4, op_type)
    for k, v in attrs.items():
        out += _field_bytes(5, _attribute(k, v))
    return out


class OnnxGraph:
    """Incremental ONNX graph builder + serializer."""

    def __init__(self, name: str = "hugectr_tpu_model", opset: int = 17):
        self.name = name
        self.opset = opset
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.inputs: List[bytes] = []
        self.outputs: List[bytes] = []
        self._uid = 0

    def uname(self, base: str) -> str:
        self._uid += 1
        return f"{base}_{self._uid}"

    def add_input(self, name, dims, elem_type=FLOAT):
        self.inputs.append(value_info(name, elem_type, dims))

    def add_output(self, name, dims, elem_type=FLOAT):
        self.outputs.append(value_info(name, elem_type, dims))

    def add_initializer(self, name: str, arr: np.ndarray) -> str:
        self.initializers.append(tensor_proto(name, arr))
        return name

    def add_node(self, op_type, inputs, outputs, **attrs):
        self.nodes.append(node_proto(op_type, inputs, outputs, **attrs))
        return outputs[0] if outputs else None

    def serialize(self) -> bytes:
        """ModelProto: ir_version=1, producer=2/3, graph=7, opset_import=8."""
        g = b""
        for n in self.nodes:
            g += _field_bytes(1, n)
        g += _field_str(2, self.name)
        for ini in self.initializers:
            g += _field_bytes(5, ini)
        for i in self.inputs:
            g += _field_bytes(11, i)
        for o in self.outputs:
            g += _field_bytes(12, o)
        model = _field_varint(1, 8)  # IR version 8
        model += _field_str(2, "hugectr_tpu")
        model += _field_str(3, "0.1")
        opset = _field_str(1, "") + _field_varint(2, self.opset)
        model += _field_bytes(7, g)
        model += _field_bytes(8, opset)
        return model

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.serialize())


# ------------------------------------------------------ minimal decoder
# (for tests: walk the wire format and recover structure)
def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def decode_fields(buf: bytes) -> List[Tuple[int, int, Union[int, bytes]]]:
    """Decode one protobuf message into [(field, wire, value)]."""
    out = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
            out.append((field, wire, v))
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            out.append((field, wire, buf[pos : pos + ln]))
            pos += ln
        elif wire == 5:
            out.append((field, wire, buf[pos : pos + 4]))
            pos += 4
        elif wire == 1:
            out.append((field, wire, buf[pos : pos + 8]))
            pos += 8
        else:
            raise ValueError(f"wire type {wire}")
    return out
