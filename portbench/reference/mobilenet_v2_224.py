"""MobileNetV2 1.0 at 224x224 (Sandler et al., arXiv:1801.04381; the
tonylins layout the DFQ reference quantizes): the frozen graph."""

from .dfq.mobilenet_v2 import mobilenet_v2


def graph(cfg: dict):
    return mobilenet_v2(n_class=cfg["num_classes"], width_mult=cfg["width_mult"])
