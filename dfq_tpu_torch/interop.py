"""Weights carried across from the JAX package.

Turns ``dfq_tpu``'s host-side objects — a params dict, a graph, a lowered
``Int8Model`` (numpy arrays throughout) — into the port's, so both
packages compute from identical numbers. The objects are read by their
fields, so this module imports nothing of ``dfq_tpu``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from dfq_tpu_torch.engine.int8 import Int8Layer, Int8Model
from dfq_tpu_torch.graph.ir import Graph, Node


def params_from_jax(params) -> Dict[str, Dict[str, Any]]:
    """``{node: {name: array}}`` with every leaf copied to numpy."""
    return {k: {n: np.array(v) for n, v in p.items()} for k, p in params.items()}


def graph_from_jax(graph) -> Graph:
    nodes = [Node(n.name, n.op, tuple(n.inputs), dict(n.attrs)) for n in graph]
    return Graph(nodes, graph.outputs)


def int8_model_from_jax(model) -> Int8Model:
    layers = {
        name: Int8Layer(
            qweight=np.array(l.qweight), w_scale=np.array(l.w_scale),
            bias=None if l.bias is None else np.array(l.bias),
            wsum=np.array(l.wsum), in_scale=float(l.in_scale), in_zp=int(l.in_zp),
        )
        for name, l in model.layers.items()
    }
    return Int8Model(
        graph=graph_from_jax(model.graph), layers=layers,
        act_ranges={k: (float(lo), float(hi)) for k, (lo, hi) in model.act_ranges.items()},
        bits_act=int(model.bits_act),
    )
