"""Minimal ONNX (protobuf) reader — no onnx/onnxruntime dependency.

The port's own copy of `cmw_tpu/mann/onnx_import.py` (that package loads
jax on import). Decodes just enough of the protobuf wire format to recover
the graph structure (nodes: op_type, inputs, outputs, attributes) and the
initializer tensors of the MANN networks (onnx_50_mann*.onnx). Pure Python
(`struct`) and numpy; returns numpy arrays.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = bytes(buf[pos : pos + 8])
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = bytes(buf[pos : pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


@dataclass
class OnnxNode:
    op_type: str = ""
    name: str = ""
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    attributes: dict = field(default_factory=dict)


_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64, 11: np.float64}


def _parse_tensor(buf: memoryview):
    dims, dtype, raw, name, floats, int64s = [], 1, b"", "", [], []
    for fnum, wtype, val in iter_fields(buf):
        if fnum == 1:  # dims
            if wtype == 0:
                dims.append(val)
            else:  # packed
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(v)
        elif fnum == 2:
            dtype = val
        elif fnum == 4:  # float_data
            if wtype == 5:
                floats.append(struct.unpack("<f", val)[0])
            else:  # packed
                floats.extend(np.frombuffer(bytes(val), np.float32).tolist())
        elif fnum == 7:  # int64_data
            if wtype == 0:
                int64s.append(val)
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int64s.append(v)
        elif fnum == 8:
            name = bytes(val).decode()
        elif fnum == 9:
            raw = bytes(val)
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw:
        arr = np.frombuffer(raw, np_dtype)
    elif floats:
        arr = np.asarray(floats, np.float32)
    elif int64s:
        arr = np.asarray(int64s, np.int64)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr


def _parse_attribute(buf: memoryview):
    name, val = "", None
    ints = []
    for fnum, wtype, v in iter_fields(buf):
        if fnum == 1:
            name = bytes(v).decode()
        elif fnum == 2:  # f
            val = struct.unpack("<f", v)[0]
        elif fnum == 3:  # i
            val = v
        elif fnum == 4:  # s
            val = bytes(v).decode(errors="replace")
        elif fnum == 5:  # t (tensor)
            val = _parse_tensor(v)[1]
        elif fnum == 8:  # ints (field 7 = floats)
            if wtype == 0:
                ints.append(v)
            else:
                p = 0
                while p < len(v):
                    x, p = _read_varint(v, p)
                    ints.append(x)
    if ints:
        val = ints
    return name, val


def _parse_node(buf: memoryview) -> OnnxNode:
    node = OnnxNode()
    for fnum, _, val in iter_fields(buf):
        if fnum == 1:
            node.inputs.append(bytes(val).decode())
        elif fnum == 2:
            node.outputs.append(bytes(val).decode())
        elif fnum == 3:
            node.name = bytes(val).decode()
        elif fnum == 4:
            node.op_type = bytes(val).decode()
        elif fnum == 5:  # NodeProto.attribute
            k, v = _parse_attribute(val)
            node.attributes[k] = v
    return node


@dataclass
class OnnxGraph:
    nodes: list
    initializers: dict
    input_names: list
    output_names: list


def _parse_value_info_name(buf: memoryview) -> str:
    for fnum, _, val in iter_fields(buf):
        if fnum == 1:
            return bytes(val).decode()
    return ""


def _parse_graph(buf: memoryview) -> OnnxGraph:
    nodes, inits, ins, outs = [], {}, [], []
    for fnum, _, val in iter_fields(buf):
        if fnum == 1:
            nodes.append(_parse_node(val))
        elif fnum == 5:
            name, arr = _parse_tensor(val)
            inits[name] = arr
        elif fnum == 11:
            ins.append(_parse_value_info_name(val))
        elif fnum == 12:
            outs.append(_parse_value_info_name(val))
    return OnnxGraph(nodes, inits, ins, outs)


def load_onnx_graph(path: str) -> OnnxGraph:
    with open(path, "rb") as f:
        data = memoryview(f.read())
    for fnum, _, val in iter_fields(data):
        if fnum == 7:  # ModelProto.graph
            return _parse_graph(val)
    raise ValueError(f"no graph found in {path}")
