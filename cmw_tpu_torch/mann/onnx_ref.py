"""Generic numpy interpreter for the (small) ONNX graphs the reference
ships — the validation oracle for network.mann_forward.

Executes nodes in graph order with a plain dict of numpy values. Supports
exactly the op set present in the MANN models (SURVEY.md §2.1 R9); `If` is
specialized to its use there (squeeze a trailing singleton dim).

A copy of `cmw_tpu/mann/onnx_ref.py` (numpy only) for the PyTorch package,
which may not import the JAX one; only the import of OnnxGraph differs.
"""

from __future__ import annotations

import numpy as np

from cmw_tpu_torch.mann.onnx_import import OnnxGraph


def _elu(x, alpha=1.0):
    return np.where(x > 0, x, alpha * (np.exp(np.minimum(x, 0.0)) - 1.0))


def run_graph(g: OnnxGraph, feeds: dict) -> dict:
    vals = dict(feeds)
    for name, arr in g.initializers.items():
        vals[name] = np.asarray(arr)
    for n in g.nodes:
        i = [vals[k] for k in n.inputs if k]
        a = n.attributes
        op = n.op_type
        if op == "Gemm":
            A, B = i[0], i[1]
            if a.get("transA", 0):
                A = A.T
            if a.get("transB", 0):
                B = B.T
            out = a.get("alpha", 1.0) * (A @ B)
            if len(i) > 2:
                out = out + a.get("beta", 1.0) * i[2]
        elif op == "MatMul":
            out = i[0] @ i[1]
        elif op == "Add":
            out = i[0] + i[1]
        elif op == "Elu":
            out = _elu(i[0], a.get("alpha", 1.0))
        elif op == "Softmax":
            ax = a.get("axis", -1)
            e = np.exp(i[0] - i[0].max(axis=ax, keepdims=True))
            out = e / e.sum(axis=ax, keepdims=True)
        elif op == "Transpose":
            out = np.transpose(i[0], a.get("perm"))
        elif op == "Unsqueeze":
            out = i[0]
            for ax in a.get("axes", [0]):
                # varint parse yields -1 as uint64 wraparound
                ax = int(ax) if int(ax) < 2**31 else int(ax) - 2**64
                out = np.expand_dims(out, ax)
        elif op == "Einsum":
            out = np.einsum(a["equation"], *i)
        elif op == "Constant":
            out = np.asarray(a["value"])
        elif op == "Shape":
            out = np.asarray(i[0].shape, np.int64)
        elif op == "Gather":
            out = np.take(i[0], i[1].astype(np.int64), axis=a.get("axis", 0))
        elif op == "Equal":
            out = i[0] == i[1]
        elif op == "If":
            # MANN graphs use If only to normalize [1,91,1] -> [1,91]: the
            # branch condition checks the shape of the tensor feeding the
            # Shape node; reproduce that reshape directly.
            src = None
            for m in g.nodes:
                if m.op_type == "Shape":
                    src = vals[m.inputs[0]]
            out = src.reshape(src.shape[0], -1) if src.ndim == 3 else src
        else:
            raise NotImplementedError(op)
        vals[n.outputs[0]] = out
    return {o: vals[o] for o in g.output_names}
