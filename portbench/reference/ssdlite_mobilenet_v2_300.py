"""MobileNetV2 SSD-Lite at 300x300 with 21 VOC classes and 3000 priors
(qfgaohao/pytorch-ssd ``mb2-ssd-lite``): the frozen graph and priors."""

from .dfq.ssd import SSDConfig, mobilenet_v2_ssd_lite, quantized_priors


def graph(cfg: dict):
    return mobilenet_v2_ssd_lite(num_classes=cfg["num_classes"])


def priors(cfg: dict):
    """The prior boxes, fake-quantized as the DFQ reference does when it
    quantizes (``mobilenet_v2_ssd_lite.py:57-59``)."""
    return quantized_priors(SSDConfig(image_size=cfg["image_size"]))
