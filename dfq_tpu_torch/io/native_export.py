"""Export an :class:`~dfq_tpu_torch.engine.int8.Int8Model` to the native
runtime's format (port of ``dfq_tpu/io/native_export.py``; for the same
model both write the same bytes).

The ncnn deployment triple (``model_int8.param/bin`` + ``.table``,
reference ``convert_ncnn.py:141-209``) maps to:

- ``<prefix>.dfqparam``: line-based text, the graph's nodes with their
  attributes in the IR's order, per-layer quantization metadata, then
  ``outputs``, ``bits_act`` and the tensor directory (name, dtype, dims,
  byte offset into the blob);
- ``<prefix>.dfqbin``: the tensors, little-endian and concatenated.

Numbers in the text are written as Python writes a Python ``float`` or
``int``: a layer's input scale with ``repr`` and the activation ranges
with ``str``, whatever numpy scalar type the model holds them in (under
numpy 2 ``repr(np.float64(x))`` is ``np.float64(x)``, and a float32
prints its shortest float32 digits). float64 tensors are written as
float32, int64 as int32. Read by the C++ runtime in ``native/``
(:mod:`dfq_tpu_torch.engine.native`).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np

from dfq_tpu_torch.engine.int8 import Int8Model
from dfq_tpu_torch.graph.ir import node_sites

_DTYPES = {np.dtype("int8"): "i8", np.dtype("float32"): "f32", np.dtype("int32"): "i32"}


def _attr(k: str, v) -> str:
    if v is None or isinstance(v, bool):
        return f"{k}={int(bool(v)) if v is not None else -1}"
    if isinstance(v, (tuple, list)):
        return f"{k}={','.join(str(x) for x in v)}"
    return f"{k}={v}"


def save_native_artifact(
    prefix: str, model: Int8Model, params_f32: Dict[str, Dict[str, Any]]
) -> None:
    lines: List[str] = ["dfqrt 1"]
    tensors: List[np.ndarray] = []
    tensor_lines: List[str] = []
    offset = 0

    def add_tensor(name: str, arr) -> None:
        nonlocal offset
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        if arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        dims = " ".join(str(d) for d in arr.shape)
        tensor_lines.append(
            f"tensor {name} {_DTYPES[arr.dtype]} {arr.ndim} {dims} {offset} {arr.nbytes}")
        tensors.append(arr)
        offset += arr.nbytes

    for node in model.graph:
        attrs = [_attr(k, v) for k, v in node.attrs.items()]
        # activation-range fake-quant sites of the inputs that are not
        # folded into an int8 layer's input quantization
        for i, site in enumerate(node_sites(node)):
            if node.name in model.layers and i == 0:
                continue
            if site in model.act_ranges:
                lo, hi = model.act_ranges[site]
                attrs.append(f"aq{i}={float(lo)},{float(hi)}")

        if node.name in model.layers:
            layer = model.layers[node.name]
            qn = node.name.replace(" ", "_")
            add_tensor(f"{qn}#qw", layer.qweight)
            add_tensor(f"{qn}#ws", layer.w_scale)
            add_tensor(f"{qn}#wsum", layer.wsum)
            attrs += ["q=1", f"in_scale={float(layer.in_scale)!r}",
                      f"in_zp={int(layer.in_zp)}"]
            if layer.bias is not None:
                add_tensor(f"{qn}#b", layer.bias)
                attrs.append("qbias=1")
        elif node.name in params_f32 and node.op in ("conv", "linear", "bn"):
            p = params_f32[node.name]
            for k in ("weight", "bias", "gamma", "beta", "mean", "var"):
                if p.get(k) is not None:
                    add_tensor(f"{node.name}#{k}", np.asarray(p[k]))
                    attrs.append(f"p_{k}=1")

        lines.append(
            f"node {node.op} {node.name} {len(node.inputs)} {' '.join(node.inputs)} "
            f"{len(attrs)} {' '.join(attrs)}".rstrip())

    lines.append(f"outputs {len(model.graph.outputs)} {' '.join(model.graph.outputs)}")
    lines.append(f"bits_act {model.bits_act}")
    lines.extend(tensor_lines)

    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    with open(prefix + ".dfqparam", "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(prefix + ".dfqbin", "wb") as f:
        for arr in tensors:
            f.write(arr.tobytes())
