"""Deployable quantized-model artifact, format 1 (port of
``dfq_tpu/io/artifact.py``; the same files and keys, so an artifact
written by either package loads in the other). One directory:

- ``manifest.json`` — graph structure (nodes/attrs/outputs), quantization
  metadata (per-layer input scale/zero-point, activation ranges, bit
  widths),
- ``tensors.npz`` — int8 weights, per-channel scales, f32 biases, weight
  column sums (``q::<layer>::weight|w_scale|wsum|bias``), plus any
  residual f32 params (``f::<node>::<name>``: non-lowered layers, BN
  identities).

Round-trips to/from :class:`dfq_tpu_torch.engine.int8.Int8Model`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

from dfq_tpu_torch.engine.int8 import Int8Layer, Int8Model
from dfq_tpu_torch.graph.ir import Graph, Node

FORMAT_VERSION = 1


def _graph_to_json(graph: Graph):
    return {
        "nodes": [
            {"name": n.name, "op": n.op, "inputs": list(n.inputs), "attrs": n.attrs}
            for n in graph
        ],
        "outputs": list(graph.outputs),
    }


def _graph_from_json(obj) -> Graph:
    def fix_attrs(attrs):
        out = {}
        for k, v in attrs.items():
            out[k] = tuple(v) if isinstance(v, list) else v
        return out

    nodes = [
        Node(d["name"], d["op"], tuple(d["inputs"]), fix_attrs(d["attrs"]))
        for d in obj["nodes"]
    ]
    return Graph(nodes, obj["outputs"])


def save_artifact(path: str, model: Int8Model, params_f32: Dict[str, Dict[str, Any]]):
    os.makedirs(path, exist_ok=True)
    tensors: Dict[str, np.ndarray] = {}
    layer_meta = {}
    for name, layer in model.layers.items():
        tensors[f"q::{name}::weight"] = np.asarray(layer.qweight)
        tensors[f"q::{name}::w_scale"] = np.asarray(layer.w_scale)
        tensors[f"q::{name}::wsum"] = np.asarray(layer.wsum)
        if layer.bias is not None:
            tensors[f"q::{name}::bias"] = np.asarray(layer.bias)
        layer_meta[name] = {
            "in_scale": layer.in_scale,
            "in_zp": layer.in_zp,
            "has_bias": layer.bias is not None,
        }
    for name, p in params_f32.items():
        for k, v in p.items():
            tensors[f"f::{name}::{k}"] = np.asarray(v)

    manifest = {
        "format_version": FORMAT_VERSION,
        "graph": _graph_to_json(model.graph),
        "layers": layer_meta,
        "act_ranges": {k: list(v) for k, v in model.act_ranges.items()},
        "bits_act": model.bits_act,
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    np.savez_compressed(os.path.join(path, "tensors.npz"), **tensors)


def load_artifact(path: str) -> Tuple[Int8Model, Dict[str, Dict[str, Any]]]:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["format_version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported artifact version {manifest['format_version']}")
    data = np.load(os.path.join(path, "tensors.npz"))

    graph = _graph_from_json(manifest["graph"])
    layers: Dict[str, Int8Layer] = {}
    for name, meta in manifest["layers"].items():
        layers[name] = Int8Layer(
            qweight=data[f"q::{name}::weight"],
            w_scale=data[f"q::{name}::w_scale"],
            bias=data[f"q::{name}::bias"] if meta["has_bias"] else None,
            wsum=data[f"q::{name}::wsum"],
            in_scale=float(meta["in_scale"]),
            in_zp=int(meta["in_zp"]),
        )
    params_f32: Dict[str, Dict[str, Any]] = {}
    for key in data.files:
        if not key.startswith("f::"):
            continue
        _, name, k = key.split("::", 2)
        params_f32.setdefault(name, {})[k] = data[key]

    model = Int8Model(
        graph=graph,
        layers=layers,
        act_ranges={k: tuple(v) for k, v in manifest["act_ranges"].items()},
        bits_act=manifest["bits_act"],
    )
    return model, params_f32
