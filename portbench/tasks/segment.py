"""A segmenter's step: the fused int8 forward, one NHWC map of class logits
per image at the input's size, and the per-pixel labels a user takes from
it (``argmax`` over the classes, as the port's ``cli/run_seg.py`` does)."""

from __future__ import annotations

import torch


class Task:
    def __init__(self, net, cfg: dict, device):
        self.net = net

    def step(self, x, spans=None):
        """As :meth:`classify.Task.step`; the labels are checked besides
        the logits."""
        logits = self.net(x)
        return logits, {"labels": logits.argmax(-1).to(torch.uint8)}
