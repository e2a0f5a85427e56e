"""MobileNetV2 SSD-Lite as a graph IR (a copy of
``dfq_tpu/models/ssd.py``).

Mirrors the reference composition
(``modeling/detection/mobilenet_v2_ssd_lite.py:24-61``,
``ssd.py:40-110``, ``nn/mobilenet_v2.py``):

- base net: MobileNetV2 features (stem + 17 blocks + 1280 conv head);
- header source 0 taps the EXPANSION output of block 14 (576 channels:
  ``GraphPath(14, 'conv', 3)``), source 1 the 1280 head output;
- 4 extra InvertedResidual stages (expand ratios < 1, stride 2);
- 6 detection heads: SeperableConv2d (depthwise 3x3 with bias + BN +
  ReLU6 + pointwise 1x1) except the last plain 1x1
  (``mobilenet_v2_ssd_lite.py:11-21,39-56``);
- per-head NHWC reshape to [N, priors, C], concat over priors, test-mode
  softmax over classes (``ssd.py:87-92,101-110``);
- priors from the mobilenetv1 SSD config (300^2, 3000 priors,
  ``config/mobilenetv1_ssd_config.py:13-23``), optionally fake-quantized
  like the reference's quantize=True path
  (``mobilenet_v2_ssd_lite.py:57-59``).

Node names equal torch module paths (``mb2-ssd-lite-mp-0_686.pth``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Tuple

import numpy as np

from .ir import Graph, GraphBuilder
from .quant import fake_quant_np


@dataclasses.dataclass(frozen=True)
class SSDSpec:
    feature_map_size: int
    shrinkage: int
    box_min: float
    box_max: float
    aspect_ratios: Tuple[int, ...]


def generate_ssd_priors(specs, image_size: int, clamp: bool = True) -> np.ndarray:
    """Center-form priors [cx, cy, w, h] relative to image size (the
    port's ``detection/box_utils.py``)."""
    priors = []
    for spec in specs:
        scale = image_size / spec.shrinkage
        for j, i in itertools.product(range(spec.feature_map_size), repeat=2):
            x_center = (i + 0.5) / scale
            y_center = (j + 0.5) / scale

            size = spec.box_min
            h = w = size / image_size
            priors.append([x_center, y_center, w, h])

            size = math.sqrt(spec.box_max * spec.box_min)
            h = w = size / image_size
            priors.append([x_center, y_center, w, h])

            size = spec.box_min
            h = w = size / image_size
            for ratio in spec.aspect_ratios:
                r = math.sqrt(ratio)
                priors.append([x_center, y_center, w * r, h / r])
                priors.append([x_center, y_center, w / r, h * r])

    out = np.array(priors, np.float32)
    if clamp:
        out = np.clip(out, 0.0, 1.0)
    return out

_SETTINGS = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]

MB2_SSD_SPECS = (
    SSDSpec(19, 16, 60, 105, (2, 3)),
    SSDSpec(10, 32, 105, 150, (2, 3)),
    SSDSpec(5, 64, 150, 195, (2, 3)),
    SSDSpec(3, 100, 195, 240, (2, 3)),
    SSDSpec(2, 150, 240, 285, (2, 3)),
    SSDSpec(1, 300, 285, 330, (2, 3)),
)


@dataclasses.dataclass
class SSDConfig:
    image_size: int = 300
    image_mean: Tuple[float, float, float] = (127.0, 127.0, 127.0)
    image_std: float = 128.0
    iou_threshold: float = 0.45
    center_variance: float = 0.1
    size_variance: float = 0.2
    priors: np.ndarray = None

    def __post_init__(self):
        if self.priors is None:
            self.priors = generate_ssd_priors(MB2_SSD_SPECS, self.image_size)


def _inverted_residual(b, act, prefix, x, inp, oup, stride, expand_ratio):
    hidden = round(inp * expand_ratio)
    block_in = x
    if expand_ratio == 1:
        x = b.conv(
            f"{prefix}.0", x, hidden, hidden, (3, 3),
            stride=(stride, stride), padding=(1, 1), groups=hidden,
        )
        x = b.bn(f"{prefix}.1", x, hidden)
        x = act(f"{prefix}.2", x)
        x = b.conv(f"{prefix}.3", x, hidden, oup, (1, 1))
        x = b.bn(f"{prefix}.4", x, oup)
    else:
        x = b.conv(f"{prefix}.0", x, inp, hidden, (1, 1))
        x = b.bn(f"{prefix}.1", x, hidden)
        x = act(f"{prefix}.2", x)
        x = b.conv(
            f"{prefix}.3", x, hidden, hidden, (3, 3),
            stride=(stride, stride), padding=(1, 1), groups=hidden,
        )
        x = b.bn(f"{prefix}.4", x, hidden)
        x = act(f"{prefix}.5", x)
        x = b.conv(f"{prefix}.6", x, hidden, oup, (1, 1))
        x = b.bn(f"{prefix}.7", x, oup)
    if stride == 1 and inp == oup:
        parent = prefix.rsplit(".conv", 1)[0]
        x = b.add(f"{parent}.add", block_in, x)
    return x


def _seperable_head(b, act, prefix, x, in_ch, out_ch):
    y = b.conv(
        f"{prefix}.0", x, in_ch, in_ch, (3, 3), padding=(1, 1),
        groups=in_ch, bias=True,
    )
    y = b.bn(f"{prefix}.1", y, in_ch)
    y = act(f"{prefix}.2", y)
    y = b.conv(f"{prefix}.3", y, in_ch, out_ch, (1, 1), bias=True)
    return y


def mobilenet_v2_ssd_lite(
    num_classes: int = 21,
    relu6: bool = True,
    is_test: bool = True,
) -> Graph:
    b = GraphBuilder()
    act = b.relu6 if relu6 else b.relu

    x = b.input("data")
    in_ch = 32
    x = b.conv("base_net.0.0", x, 3, in_ch, (3, 3), stride=(2, 2), padding=(1, 1))
    x = b.bn("base_net.0.1", x, in_ch)
    x = act("base_net.0.2", x)

    taps = []
    feat_idx = 1
    for t, c, n, s in _SETTINGS:
        for i in range(n):
            stride = s if i == 0 else 1
            prefix = f"base_net.{feat_idx}.conv"
            hidden = round(in_ch * t)
            if feat_idx == 14:
                # GraphPath(14, 'conv', 3): header 0 taps the expansion
                # output; the residual-add path is bypassed (ssd.py:63-70;
                # block 14 is stride 2 so no residual exists)
                x = b.conv(f"{prefix}.0", x, in_ch, hidden, (1, 1))
                x = b.bn(f"{prefix}.1", x, hidden)
                x = act(f"{prefix}.2", x)
                taps.append((x, hidden))
                x = b.conv(
                    f"{prefix}.3", x, hidden, hidden, (3, 3),
                    stride=(stride, stride), padding=(1, 1), groups=hidden,
                )
                x = b.bn(f"{prefix}.4", x, hidden)
                x = act(f"{prefix}.5", x)
                x = b.conv(f"{prefix}.6", x, hidden, c, (1, 1))
                x = b.bn(f"{prefix}.7", x, c)
            else:
                x = _inverted_residual(b, act, prefix, x, in_ch, c, stride, t)
            in_ch = c
            feat_idx += 1

    x = b.conv("base_net.18.0", x, in_ch, 1280, (1, 1))
    x = b.bn("base_net.18.1", x, 1280)
    x = act("base_net.18.2", x)
    taps.append((x, 1280))

    extras = [(1280, 512, 0.2), (512, 256, 0.25), (256, 256, 0.5), (256, 64, 0.25)]
    for j, (ein, eout, er) in enumerate(extras):
        x = _inverted_residual(b, act, f"extras.{j}.conv", x, ein, eout, 2, er)
        taps.append((x, eout))

    confs = []
    locs = []
    for i, (y, ch) in enumerate(taps):
        if i < 5:
            cy = _seperable_head(
                b, act, f"classification_headers.{i}", y, ch, 6 * num_classes
            )
            ly = _seperable_head(b, act, f"regression_headers.{i}", y, ch, 6 * 4)
        else:
            cy = b.conv(
                f"classification_headers.{i}", y, ch, 6 * num_classes, (1, 1),
                bias=True,
            )
            ly = b.conv(f"regression_headers.{i}", y, ch, 6 * 4, (1, 1), bias=True)
        confs.append(b.reshape(f"conf_reshape.{i}", cy, shape=(-1, num_classes)))
        locs.append(b.reshape(f"loc_reshape.{i}", ly, shape=(-1, 4)))

    conf = b.concat("conf_cat", confs, axis=1)
    loc = b.concat("loc_cat", locs, axis=1)
    if is_test:
        conf = b.softmax("conf_softmax", conf, axis=2)
    return b.build([conf, loc])


def quantized_priors(cfg: SSDConfig, bits: int = 8) -> np.ndarray:
    """The reference fake-quantizes the prior boxes themselves when
    quantize=True (``mobilenet_v2_ssd_lite.py:57-59``)."""
    p = cfg.priors
    return fake_quant_np(p, float(p.min()), float(p.max()), bits=bits)
