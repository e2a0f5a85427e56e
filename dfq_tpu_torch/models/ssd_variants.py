"""Additional SSD variants: MobileNetV1-SSD, MobileNetV1-SSD-Lite,
SqueezeNet-SSD-Lite, FPN-MobileNetV1-SSD and VGG16-SSD (a copy of
``dfq_tpu/models/ssd_variants.py``).

Behavioral contracts: reference
``modeling/detection/mobilenetv1_ssd.py`` (plain 3x3 heads, extras of
1x1+3x3s2 conv pairs), ``mobilenetv1_ssd_lite.py`` (BN-free
SeperableConv2d extras/heads), ``vgg_ssd.py`` + ``nn/vgg.py`` (conv4_3
tap through a BatchNorm add-on, ceil-mode pool, dilated conv6, mixed
4/6-prior heads, 8732 priors from ``config/vgg_ssd_config.py``).

All share the mb2 builder's conventions: NHWC, node names = torch module
paths, test-mode softmax, two outputs (conf, loc).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from dfq_tpu_torch.detection.box_utils import SSDSpec, generate_ssd_priors
from dfq_tpu_torch.graph.ir import Graph, GraphBuilder
from dfq_tpu_torch.models.ssd import SSDConfig

VGG_SSD_SPECS = (
    SSDSpec(38, 8, 30, 60, (2,)),
    SSDSpec(19, 16, 60, 111, (2, 3)),
    SSDSpec(10, 32, 111, 162, (2, 3)),
    SSDSpec(5, 64, 162, 213, (2, 3)),
    SSDSpec(3, 100, 213, 264, (2,)),
    SSDSpec(1, 300, 264, 315, (2,)),
)


def vgg_ssd_config() -> SSDConfig:
    # vgg_ssd_config.py: mean (123,117,104), std 1.0
    return SSDConfig(
        image_mean=(123.0, 117.0, 104.0),
        image_std=1.0,
        priors=generate_ssd_priors(VGG_SSD_SPECS, 300),
    )


def _mb1_backbone(b: GraphBuilder, act, x: str) -> Tuple[List[Tuple[str, int]], str]:
    """MobileNetV1 ``model`` Sequential (reference ``nn/mobilenet.py``);
    returns ([tap after block 11 (512ch), tap after block 13 (1024ch)], x)."""
    cfg = [  # (type, in, out, stride)
        ("bn", 3, 32, 2),
        ("dw", 32, 64, 1),
        ("dw", 64, 128, 2),
        ("dw", 128, 128, 1),
        ("dw", 128, 256, 2),
        ("dw", 256, 256, 1),
        ("dw", 256, 512, 2),
        ("dw", 512, 512, 1),
        ("dw", 512, 512, 1),
        ("dw", 512, 512, 1),
        ("dw", 512, 512, 1),
        ("dw", 512, 512, 1),
        ("dw", 512, 1024, 2),
        ("dw", 1024, 1024, 1),
    ]
    taps = []
    for idx, (kind, ci, co, s) in enumerate(cfg):
        p = f"base_net.{idx}"
        if kind == "bn":
            x = b.conv(f"{p}.0", x, ci, co, (3, 3), stride=(s, s), padding=(1, 1))
            x = b.bn(f"{p}.1", x, co)
            x = act(f"{p}.2", x)
        else:
            x = b.conv(
                f"{p}.0", x, ci, ci, (3, 3), stride=(s, s), padding=(1, 1),
                groups=ci,
            )
            x = b.bn(f"{p}.1", x, ci)
            x = act(f"{p}.2", x)
            x = b.conv(f"{p}.3", x, ci, co, (1, 1))
            x = b.bn(f"{p}.4", x, co)
            x = act(f"{p}.5", x)
        if idx == 11:
            taps.append((x, 512))
    taps.append((x, 1024))
    return taps, x


def _plain_extra(b, act, prefix, x, cin, mid, cout, k2_pad=1, k2_stride=2):
    x = b.conv(f"{prefix}.0", x, cin, mid, (1, 1), bias=True)
    x = act(f"{prefix}.1", x)
    x = b.conv(
        f"{prefix}.2", x, mid, cout, (3, 3),
        stride=(k2_stride, k2_stride), padding=(k2_pad, k2_pad), bias=True,
    )
    x = act(f"{prefix}.3", x)
    return x


def _lite_sep(b, act, prefix, x, cin, cout, stride=1, pad=1):
    """BN-free SeperableConv2d (mobilenetv1_ssd_lite.py:10-18)."""
    x = b.conv(
        f"{prefix}.0", x, cin, cin, (3, 3), stride=(stride, stride),
        padding=(pad, pad), groups=cin, bias=True,
    )
    x = act(f"{prefix}.1", x)
    x = b.conv(f"{prefix}.2", x, cin, cout, (1, 1), bias=True)
    return x


def _heads_and_outputs(b, taps, head_fn, num_classes, prior_counts):
    confs, locs = [], []
    for i, (y, ch) in enumerate(taps):
        k = prior_counts[i]
        cy = head_fn(f"classification_headers.{i}", y, ch, k * num_classes, i)
        ly = head_fn(f"regression_headers.{i}", y, ch, k * 4, i)
        confs.append(b.reshape(f"conf_reshape.{i}", cy, shape=(-1, num_classes)))
        locs.append(b.reshape(f"loc_reshape.{i}", ly, shape=(-1, 4)))
    conf = b.concat("conf_cat", confs, axis=1)
    loc = b.concat("loc_cat", locs, axis=1)
    conf = b.softmax("conf_softmax", conf, axis=2)
    return conf, loc


def mobilenet_v1_ssd(num_classes: int = 21) -> Graph:
    b = GraphBuilder()
    act = b.relu  # MobileNetV1 uses plain ReLU
    x = b.input("data")
    taps, x = _mb1_backbone(b, act, x)

    extras = [(1024, 256, 512), (512, 128, 256), (256, 128, 256), (256, 128, 256)]
    for j, (ci, mid, co) in enumerate(extras):
        x = _plain_extra(b, act, f"extras.{j}", x, ci, mid, co)
        taps.append((x, co))

    def head(prefix, y, ch, cout, i):
        return b.conv(prefix, y, ch, cout, (3, 3), padding=(1, 1), bias=True)

    conf, loc = _heads_and_outputs(b, taps, head, num_classes, [6] * 6)
    return b.build([conf, loc])


def mobilenet_v1_ssd_lite(num_classes: int = 21) -> Graph:
    b = GraphBuilder()
    act = b.relu
    x = b.input("data")
    taps, x = _mb1_backbone(b, act, x)

    extras = [(1024, 256, 512), (512, 128, 256), (256, 128, 256), (256, 128, 256)]
    for j, (ci, mid, co) in enumerate(extras):
        x = b.conv(f"extras.{j}.0", x, ci, mid, (1, 1), bias=True)
        x = act(f"extras.{j}.1", x)
        x = _lite_sep(b, act, f"extras.{j}.2", x, mid, co, stride=2, pad=1)
        taps.append((x, co))

    def head(prefix, y, ch, cout, i):
        if i < 5:
            return _lite_sep(b, act, prefix, y, ch, cout)
        return b.conv(prefix, y, ch, cout, (1, 1), bias=True)

    conf, loc = _heads_and_outputs(b, taps, head, num_classes, [6] * 6)
    return b.build([conf, loc])


SQUEEZENET_SSD_SPECS = (
    SSDSpec(17, 16, 60, 105, (2, 3)),
    SSDSpec(10, 32, 105, 150, (2, 3)),
    SSDSpec(5, 64, 150, 195, (2, 3)),
    SSDSpec(3, 100, 195, 240, (2, 3)),
    SSDSpec(2, 150, 240, 285, (2, 3)),
    SSDSpec(1, 300, 285, 330, (2, 3)),
)


def squeezenet_ssd_config() -> SSDConfig:
    return SSDConfig(priors=generate_ssd_priors(SQUEEZENET_SSD_SPECS, 300))


def _fire(b, prefix, x, inp, squeeze, e1, e3):
    """SqueezeNet Fire module (reference nn/squeezenet.py:17-37):
    squeeze 1x1 -> relu -> concat(expand1x1+relu, expand3x3+relu)."""
    s = b.conv(f"{prefix}.squeeze", x, inp, squeeze, (1, 1), bias=True)
    s = b.relu(f"{prefix}.squeeze_activation", s)
    a = b.conv(f"{prefix}.expand1x1", s, squeeze, e1, (1, 1), bias=True)
    a = b.relu(f"{prefix}.expand1x1_activation", a)
    c = b.conv(f"{prefix}.expand3x3", s, squeeze, e3, (3, 3), padding=(1, 1),
               bias=True)
    c = b.relu(f"{prefix}.expand3x3_activation", c)
    return b.concat(f"{prefix}.cat", [a, c], axis=-1)


def squeezenet_ssd_lite(num_classes: int = 21) -> Graph:
    """SqueezeNet-1.1 SSD-Lite (reference squeezenet_ssd_lite.py:21-74):
    single base tap after features[11] (512ch @ 17x17 for 300^2 input —
    the stem conv and pools are unpadded/floor), 5 BN-free separable
    extras, separable heads, 17/10/5/3/2/1 prior grids."""
    b = GraphBuilder()
    act = b.relu
    x = b.input("data")
    x = b.conv("base_net.0", x, 3, 64, (3, 3), stride=(2, 2), bias=True)
    x = act("base_net.1", x)
    x = b.maxpool("base_net.2", x, window=(3, 3), stride=(2, 2))
    x = _fire(b, "base_net.3", x, 64, 16, 64, 64)
    x = _fire(b, "base_net.4", x, 128, 16, 64, 64)
    x = b.maxpool("base_net.5", x, window=(3, 3), stride=(2, 2))
    x = _fire(b, "base_net.6", x, 128, 32, 128, 128)
    x = _fire(b, "base_net.7", x, 256, 32, 128, 128)
    x = b.maxpool("base_net.8", x, window=(3, 3), stride=(2, 2))
    x = _fire(b, "base_net.9", x, 256, 48, 192, 192)
    x = _fire(b, "base_net.10", x, 384, 48, 192, 192)
    x = _fire(b, "base_net.11", x, 384, 64, 256, 256)
    taps = [(x, 512)]
    x = _fire(b, "base_net.12", x, 512, 64, 256, 256)

    extras = [
        (512, 256, 512, 2),  # SeperableConv2d pad=2 on the first extra
        (512, 256, 512, 1),
        (512, 128, 256, 1),
        (256, 128, 256, 1),
        (256, 128, 256, 1),
    ]
    for j, (ci, mid, co, pad) in enumerate(extras):
        x = b.conv(f"extras.{j}.0", x, ci, mid, (1, 1), bias=True)
        x = act(f"extras.{j}.1", x)
        x = _lite_sep(b, act, f"extras.{j}.2", x, mid, co, stride=2, pad=pad)
        taps.append((x, co))

    def head(prefix, y, ch, cout, i):
        if i < 5:
            return _lite_sep(b, act, prefix, y, ch, cout)
        return b.conv(prefix, y, ch, cout, (1, 1), bias=True)

    conf, loc = _heads_and_outputs(b, taps, head, num_classes, [6] * 6)
    return b.build([conf, loc])


def fpn_mobilenet_v1_ssd(num_classes: int = 21) -> Graph:
    """FPN-SSD over MobileNetV1 (reference fpn_ssd.py:36-86 +
    fpn_mobilenetv1_ssd.py). NOTE: the reference composition is dead
    code and broken as written (it accesses ``MobileNetV1.features``
    which does not exist, ``fpn_mobilenetv1_ssd.py:11``); this is the
    corrected equivalent: taps after blocks 11/13 projected to 256ch,
    extras to 256ch, top-down bilinear upsample+add, 3x3 heads on the
    merged 256-channel pyramid."""
    b = GraphBuilder()
    act = b.relu
    x = b.input("data")
    taps, x = _mb1_backbone(b, act, x)
    # project base taps to the 256-ch pyramid (source_layer_add_ons)
    sizes = [19, 10]
    feats = []
    for i, (y, ch) in enumerate(taps):
        y = b.conv(f"source_layer_add_ons.{i}", y, ch, 256, (1, 1), bias=True)
        feats.append(y)

    extras = [(1024, 256, 256), (256, 128, 256), (256, 128, 256), (256, 128, 256)]
    for j, (ci, mid, co) in enumerate(extras):
        x = _plain_extra(b, act, f"extras.{j}", x, ci, mid, co)
        feats.append(x)
    sizes += [5, 3, 2, 1]

    # top-down pathway (fpn_ssd.py:73-82)
    merged = [None] * 6
    upstream = feats[5]
    merged[5] = upstream
    for i in range(4, -1, -1):
        up = b.interpolate(
            f"fpn_up.{i}", upstream, size=(sizes[i], sizes[i]),
            mode="bilinear", align_corners=False,
        )
        upstream = b.add(f"fpn_add.{i}", up, feats[i])
        merged[i] = upstream

    def head(prefix, y, ch, cout, i):
        return b.conv(prefix, y, ch, cout, (3, 3), padding=(1, 1), bias=True)

    conf, loc = _heads_and_outputs(
        b, [(m, 256) for m in merged], head, num_classes, [6] * 6
    )
    return b.build([conf, loc])


def vgg16_ssd(num_classes: int = 21) -> Graph:
    b = GraphBuilder()
    x = b.input("data")
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "C", 512, 512, 512, "M",
           512, 512, 512]
    in_ch = 3
    idx = 0
    tap_conv43 = None
    for v in cfg:
        if v == "M":
            x = b.maxpool(f"base_net.{idx}", x, window=(2, 2), stride=(2, 2))
            idx += 1
        elif v == "C":
            # ceil-mode 2x2 pool: pad bottom/right then floor pool; safe
            # post-ReLU (activations >= 0 so zero padding can't win the max)
            x = b.pad(f"base_net.{idx}.pad", x, pads=(0, 1, 0, 1))
            x = b.maxpool(f"base_net.{idx}", x, window=(2, 2), stride=(2, 2))
            idx += 1
        else:
            x = b.conv(f"base_net.{idx}", x, in_ch, v, (3, 3), padding=(1, 1),
                       bias=True)
            idx += 1
            x = b.relu(f"base_net.{idx}", x)
            idx += 1
            in_ch = v
        if idx == 23:
            tap_conv43 = x

    # conv4_3 tap through the BatchNorm add-on (vgg_ssd.py:16-17)
    y0 = b.bn("source_layer_add_ons.0", tap_conv43, 512)

    x = b.maxpool(f"base_net.{idx}", x, window=(3, 3), stride=(1, 1), padding=(1, 1))
    idx += 1
    x = b.conv(f"base_net.{idx}", x, 512, 1024, (3, 3), padding=(6, 6),
               dilation=(6, 6), bias=True)
    idx += 1
    x = b.relu(f"base_net.{idx}", x)
    idx += 1
    x = b.conv(f"base_net.{idx}", x, 1024, 1024, (1, 1), bias=True)
    idx += 1
    x = b.relu(f"base_net.{idx}", x)

    taps = [(y0, 512), (x, 1024)]
    extras = [
        (1024, 256, 512, 1, 2),
        (512, 128, 256, 1, 2),
        (256, 128, 256, 0, 1),
        (256, 128, 256, 0, 1),
    ]
    for j, (ci, mid, co, pad, st) in enumerate(extras):
        x = _plain_extra(b, b.relu, f"extras.{j}", x, ci, mid, co,
                         k2_pad=pad, k2_stride=st)
        taps.append((x, co))

    def head(prefix, y, ch, cout, i):
        return b.conv(prefix, y, ch, cout, (3, 3), padding=(1, 1), bias=True)

    conf, loc = _heads_and_outputs(
        b, taps, head, num_classes, [4, 6, 6, 6, 4, 4]
    )
    return b.build([conf, loc])
