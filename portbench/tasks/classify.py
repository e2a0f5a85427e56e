"""A classifier's step: the fused int8 forward, one row of logits per image."""

from __future__ import annotations


class Task:
    def __init__(self, net, cfg: dict, device):
        self.net = net

    def step(self, x, spans=None):
        """``x``: NHWC images on the device -> ``(rows, aux)``: the
        per-image results, and the tensors besides them that are checked
        (none here)."""
        return self.net(x), {}
