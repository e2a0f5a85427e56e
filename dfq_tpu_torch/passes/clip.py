"""Weight clipping (the README's ``+clip_15`` rows).

Reference: ``clip_weight`` (``dfq.py:167-170``) — clamp
all target-layer weights into ``[-15, 15]`` before quantization.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from dfq_tpu_torch.graph.ir import Graph

_TARGET = {"conv", "linear"}


def clip_weights(
    graph: Graph,
    params: Dict[str, Dict[str, Any]],
    range_clip: Tuple[float, float] = (-15.0, 15.0),
) -> Dict[str, Dict[str, Any]]:
    params = {k: dict(v) for k, v in params.items()}
    for node in graph:
        if node.op in _TARGET and node.name in params:
            p = dict(params[node.name])
            p["weight"] = np.clip(p["weight"], range_clip[0], range_clip[1]).astype(
                np.float32
            )
            params[node.name] = p
    return params
