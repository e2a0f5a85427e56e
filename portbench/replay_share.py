"""The reader of ``graph_replay_share.*``: the share of the fused engine's
forwards over the run that replayed a CUDA graph, from the program's
counters (``int8_fused.GRAPH_COUNTS``). Nothing is read where the program
keeps no such counters or ran no forward."""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional


def replay_share_pct(t: Dict) -> Optional[float]:
    """Replays over replays and step-by-step forwards, in %; the counters
    go to standard error."""
    from dfq_tpu_torch.engine import int8_fused

    counts = getattr(int8_fused, "GRAPH_COUNTS", None)
    if not counts or not counts["replays"] + counts["eager"]:
        return None
    print(f"graph counters: {json.dumps(counts)}", file=sys.stderr, flush=True)
    return 100.0 * counts["replays"] / (counts["replays"] + counts["eager"])
