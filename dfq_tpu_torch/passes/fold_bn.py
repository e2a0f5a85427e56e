"""BatchNorm folding with data-free statistics retention.

Behavioral contract: reference ``merge_batchnorm``
(``utils/layer_transform.py:231-276``):

- For every ``conv/linear -> bn`` edge, fold: ``W' = W * g/sqrt(v+eps)``
  (per output channel), ``b' = b * g/sqrt(v+eps) + beta - g*m/sqrt(v+eps)``.
- The BN node keeps ``stat_std = |gamma|`` (pre-fold effective std) and
  ``stat_mean = beta`` (pre-fold mean) — the reference's
  ``fake_weight``/``fake_bias`` buffers (``:264-265``) that all data-free
  passes consume.
- The BN node is neutralized in place (gamma=1, beta=0, mean=0, var=1,
  eps=0, ``:268-272``) so it stays a ``bn`` op — downstream passes
  (relations, range setting, bias correction) keep finding it — while
  computing an exact identity.

Pure function: returns a new ``(graph, params)``; inputs not mutated.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from dfq_tpu_torch.graph.ir import Graph


def fold_batchnorm(
    graph: Graph, params: Dict[str, Dict[str, Any]]
) -> Tuple[Graph, Dict[str, Dict[str, Any]]]:
    params = {k: dict(v) for k, v in params.items()}
    new_nodes = []
    for node in graph:
        if node.op == "bn" and "stat_std" not in params.get(node.name, {}):
            (bot_name,) = node.inputs
            bot = graph[bot_name] if bot_name in graph else None
            if bot is not None and bot.op in ("conv", "linear"):
                p_bn = params[node.name]
                gamma = np.asarray(p_bn["gamma"], np.float32)
                beta = np.asarray(p_bn["beta"], np.float32)
                mean = np.asarray(p_bn["mean"], np.float32)
                var = np.asarray(p_bn["var"], np.float32)
                eps = node.attrs.get("eps", 1e-5)
                inv_std = gamma / np.sqrt(var + eps)

                p_l = dict(params[bot_name])
                w = np.asarray(p_l["weight"], np.float32)
                shape = (-1,) + (1,) * (w.ndim - 1)
                p_l["weight"] = (w * inv_std.reshape(shape)).astype(np.float32)
                b = np.asarray(
                    p_l.get("bias", np.zeros(w.shape[0], np.float32)), np.float32
                )
                p_l["bias"] = (b * inv_std + beta - inv_std * mean).astype(np.float32)
                params[bot_name] = p_l

                # neutralize the BN but keep the data-free statistics
                c = gamma.shape[0]
                params[node.name] = {
                    "gamma": np.ones(c, np.float32),
                    "beta": np.zeros(c, np.float32),
                    "mean": np.zeros(c, np.float32),
                    "var": np.ones(c, np.float32),
                    "stat_std": np.abs(gamma).astype(np.float32),
                    "stat_mean": beta.copy(),
                }
                attrs = dict(node.attrs)
                attrs["eps"] = 0.0
                new_nodes.append(node.replace(attrs=attrs))
                continue
        new_nodes.append(node)
    return Graph(new_nodes, graph.outputs), params

