"""Parameter initialization and torch-checkpoint conversion.

Params are host-side numpy float32 dicts during graph passes; the int8
engine packs them onto the device once, at construction. Conv weights OIHW,
linear ``[out, in]`` — matching torch layouts so converting a reference
checkpoint is a key-wise copy (node names follow torch module paths).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from dfq_tpu_torch.graph.ir import Graph


def init_params(
    graph: Graph, seed: int = 0, bn_stats: str = "identity"
) -> Dict[str, Dict[str, Any]]:
    """Random-normal conv/linear init mirroring the reference's scheme
    (``modeling/classification/MobileNetV2.py:116-129``).

    ``bn_stats="random"`` draws diverse BatchNorm statistics (lognormal
    gamma/std, normal beta/mean) so data-free passes have non-trivial
    ranges to work with in tests.
    """
    rng = np.random.default_rng(seed)
    params: Dict[str, Dict[str, Any]] = {}
    for node in graph:
        if node.op == "conv":
            kh, kw = node.attrs["kernel"]
            o, i, g = node.attrs["out_ch"], node.attrs["in_ch"], node.attrs["groups"]
            n = kh * kw * o
            p = {
                "weight": rng.normal(0.0, np.sqrt(2.0 / n), (o, i // g, kh, kw)).astype(
                    np.float32
                )
            }
            if node.attrs.get("bias"):
                p["bias"] = np.zeros((o,), np.float32)
            params[node.name] = p
        elif node.op == "linear":
            o, i = node.attrs["out_f"], node.attrs["in_f"]
            p = {"weight": rng.normal(0.0, 0.01, (o, i)).astype(np.float32)}
            if node.attrs.get("bias"):
                p["bias"] = np.zeros((o,), np.float32)
            params[node.name] = p
        elif node.op == "bn":
            c = node.attrs["ch"]
            if bn_stats == "random":
                params[node.name] = {
                    "gamma": rng.lognormal(0.0, 0.5, (c,)).astype(np.float32),
                    "beta": rng.normal(0.0, 0.5, (c,)).astype(np.float32),
                    "mean": rng.normal(0.0, 0.2, (c,)).astype(np.float32),
                    "var": rng.lognormal(0.0, 0.5, (c,)).astype(np.float32),
                }
            else:
                params[node.name] = {
                    "gamma": np.ones((c,), np.float32),
                    "beta": np.zeros((c,), np.float32),
                    "mean": np.zeros((c,), np.float32),
                    "var": np.ones((c,), np.float32),
                }
        elif node.op == "l2norm":
            c = node.attrs["ch"]
            s0 = float(node.attrs.get("initial_scale", 20.0))
            params[node.name] = {"scale": np.full((c,), s0, np.float32)}
    return params


_BN_KEYS = {
    "weight": "gamma",
    "bias": "beta",
    "running_mean": "mean",
    "running_var": "var",
}


def load_torch_state_dict(
    graph: Graph,
    state_dict: Dict[str, Any],
    name_map: Optional[Dict[str, str]] = None,
) -> Dict[str, Dict[str, Any]]:
    """Convert a torch ``state_dict`` (tensors or numpy arrays) into a
    params pytree. Node names must equal torch module paths (our model
    builders guarantee this), or be mapped via ``name_map``.
    """

    def to_np(v):
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.asarray(v, dtype=np.float32)

    name_map = name_map or {}
    params: Dict[str, Dict[str, Any]] = {}
    for node in graph:
        prefix = name_map.get(node.name, node.name)
        if node.op in ("conv", "linear"):
            key = f"{prefix}.weight"
            if key not in state_dict:
                raise KeyError(f"missing {key} for node {node.name}")
            p = {"weight": to_np(state_dict[key])}
            bkey = f"{prefix}.bias"
            if bkey in state_dict:
                p["bias"] = to_np(state_dict[bkey])
            params[node.name] = p
        elif node.op == "bn":
            p = {}
            for tk, ok in _BN_KEYS.items():
                key = f"{prefix}.{tk}"
                if key not in state_dict:
                    raise KeyError(f"missing {key} for node {node.name}")
                p[ok] = to_np(state_dict[key])
            params[node.name] = p
        elif node.op == "l2norm":
            params[node.name] = {"scale": to_np(state_dict[f"{prefix}.scale"])}
    return params
