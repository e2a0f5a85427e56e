"""Megabytes (10**6 bytes) that the fused engine's f32 fallback steps write
per image: the program's record (``int8_fused.FALLBACK_BYTES``, each
fallback step's f32 output an image, from its shape). The split by op
goes to standard error. Nothing is read where the program keeps no such
record or ran no fallback step."""

from __future__ import annotations

import json
import sys


def read(t):
    from dfq_tpu_torch.engine import int8_fused

    steps = getattr(int8_fused, "FALLBACK_BYTES", None)
    if not steps:
        return None
    by_op = {}
    for op, nbytes in steps.values():
        c = by_op.setdefault(op, {"steps": 0, "mb_per_image": 0.0})
        c["steps"] += 1
        c["mb_per_image"] += nbytes / 1e6
    print(f"f32 fallback by op: {json.dumps(dict(sorted(by_op.items())))}", file=sys.stderr,
          flush=True)
    return sum(nbytes for _, nbytes in steps.values()) / 1e6
