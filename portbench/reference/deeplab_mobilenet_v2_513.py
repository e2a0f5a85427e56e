"""DeepLab-v3+ on MobileNetV2 1.0 at 513x513, output stride 16, 21 VOC
classes (Chen et al., arXiv:1802.02611; jfzhang95/pytorch-deeplab-xception's
layout, which the DFQ reference quantizes): the frozen graph."""

from .dfq.deeplab import deeplab_mobilenet_v2


def graph(cfg: dict):
    return deeplab_mobilenet_v2(n_class=cfg["num_classes"], output_stride=cfg["output_stride"],
                                input_size=cfg["image_size"])
