"""Params checkpoints (the API of ``dfq_tpu/io/checkpoint.py``, which writes
orbax; the port writes a directory of its own that needs neither orbax
nor pickle):

- ``params.npz``: every array of ``{node: {name: array}}`` under the key
  ``<node>::<name>``, stored uncompressed with its dtype;
- ``act_ranges.json``: ``{site: [lo, hi]}``, present only when ranges
  were given.

Loading returns ``(params, ranges)``, with ``ranges`` ``None`` when none
were saved, arrays with the dtypes and values they were saved with, and
each range as a pair of Python floats (JSON keeps a float's every bit).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

_PARAMS = "params.npz"
_RANGES = "act_ranges.json"


def save_params(
    path: str,
    params: Dict[str, Dict[str, Any]],
    act_ranges: Optional[Dict[str, Tuple[float, float]]] = None,
) -> None:
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for node, p in params.items():
        for name, v in p.items():
            if "::" in node or "::" in name:
                raise ValueError(f"'::' in a params key: {node!r}, {name!r}")
            arr = np.asarray(v)
            if arr.dtype.hasobject:  # would need pickle to load
                raise ValueError(f"params[{node!r}][{name!r}] is not a numeric array")
            arrays[f"{node}::{name}"] = arr
    np.savez(os.path.join(path, _PARAMS), **arrays)
    ranges_path = os.path.join(path, _RANGES)
    if act_ranges is not None:
        with open(ranges_path, "w") as f:
            json.dump({k: [float(lo), float(hi)] for k, (lo, hi) in act_ranges.items()}, f)
    elif os.path.exists(ranges_path):
        os.remove(ranges_path)


def load_params(path: str):
    params: Dict[str, Dict[str, Any]] = {}
    with np.load(os.path.join(path, _PARAMS), allow_pickle=False) as data:
        for key in data.files:
            node, name = key.split("::", 1)
            params.setdefault(node, {})[name] = data[key]
    ranges = None
    ranges_path = os.path.join(path, _RANGES)
    if os.path.exists(ranges_path):
        with open(ranges_path) as f:
            ranges = {k: (float(v[0]), float(v[1])) for k, v in json.load(f).items()}
    return params, ranges
