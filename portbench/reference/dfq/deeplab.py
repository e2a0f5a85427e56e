"""DeepLab-v3+ on MobileNetV2 as a graph IR builder (a frozen copy of
``_aspp_and_decoder`` and ``deeplab_mobilenet_v2`` from
``dfq_tpu_torch/models/deeplab.py``).

Mirrors jfzhang95/pytorch-deeplab-xception, the model the DFQ reference
quantizes (``modeling/deeplab.py:9-36``, ``aspp.py:41-86``,
``decoder.py:7-43``, ``backbone/mobilenet.py:25-121``):

- backbone: MobileNetV2 with dilated later stages (output_stride 16:
  blocks after cumulative stride 16 use stride 1 with rising dilation);
  ``fixed_padding`` pads the block input explicitly and the depthwise
  conv runs unpadded, which stays observable after BN folding gives the
  pointwise conv a bias;
- low-level feature tap after block 3 (24 channels);
- ASPP: 1x1 and three dilated 3x3 branches (6/12/18 at os16) and a
  global-pool branch resized bilinear with aligned corners, a concat of
  5x256, a 1x1 projection and dropout;
- decoder: 1x1 on the low-level tap (24->48), a resize to its size, a
  concat of 304, two 3x3 convs and the classifier;
- a final bilinear resize to the input size.

Node names equal the reference's torch module paths.
"""

from __future__ import annotations

from .ir import Graph, GraphBuilder

_SETTINGS = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def _conv_out(h: int, stride: int) -> int:
    # 3x3 conv, effective padding (d, d) with dilation d, stride s:
    # floor((h - 1)/s) + 1
    return (h - 1) // stride + 1


def _aspp_and_decoder(
    b: GraphBuilder, x: str, low_level: str, *,
    inplanes: int, low_level_ch: int, h: int, low_h: int,
    n_class: int, output_stride: int, input_size: int,
):
    """Shared ASPP + decoder + final upsample (aspp.py:55-79,
    decoder.py:22-43, deeplab.py:32)."""
    dilations = [1, 6, 12, 18] if output_stride == 16 else [1, 12, 24, 36]
    branches = []
    for i, d in enumerate(dilations, start=1):
        k = 1 if i == 1 else 3
        pad = 0 if i == 1 else d
        y = b.conv(
            f"aspp.aspp{i}.atrous_conv", x, inplanes, 256, (k, k),
            padding=(pad, pad), dilation=(d, d),
        )
        y = b.bn(f"aspp.aspp{i}.bn", y, 256)
        y = b.relu(f"aspp.aspp{i}.relu", y)
        branches.append(y)
    g = b.global_pool("aspp.global_avg_pool.0", x)
    g = b.conv("aspp.global_avg_pool.1", g, inplanes, 256, (1, 1))
    g = b.bn("aspp.global_avg_pool.2", g, 256)
    g = b.relu("aspp.global_avg_pool.3", g)
    g = b.interpolate(
        "aspp.pool_up", g, size=(h, h), mode="bilinear", align_corners=True
    )
    branches.append(g)
    x = b.concat("aspp.cat", branches, axis=-1)
    x = b.conv("aspp.conv1", x, 1280, 256, (1, 1))
    x = b.bn("aspp.bn1", x, 256)
    x = b.relu("aspp.relu", x)
    x = b.dropout("aspp.dropout", x)

    ll = b.conv("decoder.conv1", low_level, low_level_ch, 48, (1, 1))
    ll = b.bn("decoder.bn1", ll, 48)
    ll = b.relu("decoder.relu", ll)
    x = b.interpolate(
        "decoder.up", x, size=(low_h, low_h), mode="bilinear", align_corners=True
    )
    x = b.concat("decoder.cat", [x, ll], axis=-1)
    x = b.conv("decoder.last_conv.0", x, 304, 256, (3, 3), padding=(1, 1))
    x = b.bn("decoder.last_conv.1", x, 256)
    x = b.relu("decoder.last_conv.2", x)
    x = b.dropout("decoder.last_conv.3", x)
    x = b.conv("decoder.last_conv.4", x, 256, 256, (3, 3), padding=(1, 1))
    x = b.bn("decoder.last_conv.5", x, 256)
    x = b.relu("decoder.last_conv.6", x)
    x = b.dropout("decoder.last_conv.7", x)
    x = b.conv("decoder.last_conv.8", x, 256, n_class, (1, 1), bias=True)
    x = b.interpolate(
        "final_up", x, size=(input_size, input_size), mode="bilinear",
        align_corners=True,
    )
    return x


def deeplab_mobilenet_v2(
    n_class: int = 21,
    output_stride: int = 16,
    input_size: int = 513,
    relu6: bool = True,
) -> Graph:
    b = GraphBuilder()
    act = b.relu6 if relu6 else b.relu

    x = b.input("data")
    h = input_size
    in_ch = 32
    x = b.conv(
        "backbone.features.0.0", x, 3, in_ch, (3, 3), stride=(2, 2), padding=(1, 1)
    )
    h = _conv_out(h, 2)
    x = b.bn("backbone.features.0.1", x, in_ch)
    x = act("backbone.features.0.2", x)

    current_stride = 2
    rate = 1
    feat_idx = 1
    low_level = None
    low_h = None
    for t, c, n, s in _SETTINGS:
        if current_stride == output_stride:
            stride, dilation = 1, rate
            rate *= s
        else:
            stride, dilation = s, 1
            current_stride *= s
        for i in range(n):
            st = stride if i == 0 else 1
            prefix = f"backbone.features.{feat_idx}.conv"
            hidden = round(in_ch * t)
            block_in = x
            # fixed_padding on the block input (symmetric for k=3)
            d = dilation
            x = b.pad(f"backbone.features.{feat_idx}.pad", x, pads=(d, d, d, d))
            if t == 1:
                x = b.conv(
                    f"{prefix}.0", x, hidden, hidden, (3, 3),
                    stride=(st, st), padding=(0, 0), dilation=(d, d), groups=hidden,
                )
                x = b.bn(f"{prefix}.1", x, hidden)
                x = act(f"{prefix}.2", x)
                x = b.conv(f"{prefix}.3", x, hidden, c, (1, 1))
                x = b.bn(f"{prefix}.4", x, c)
            else:
                x = b.conv(f"{prefix}.0", x, in_ch, hidden, (1, 1))
                x = b.bn(f"{prefix}.1", x, hidden)
                x = act(f"{prefix}.2", x)
                x = b.conv(
                    f"{prefix}.3", x, hidden, hidden, (3, 3),
                    stride=(st, st), padding=(0, 0), dilation=(d, d), groups=hidden,
                )
                x = b.bn(f"{prefix}.4", x, hidden)
                x = act(f"{prefix}.5", x)
                x = b.conv(f"{prefix}.6", x, hidden, c, (1, 1))
                x = b.bn(f"{prefix}.7", x, c)
            if st == 1 and in_ch == c:
                x = b.add(f"backbone.features.{feat_idx}.add", block_in, x)
            h = _conv_out(h, st)
            in_ch = c
            if feat_idx == 3:  # low_level_features = features[0:4]
                low_level = x
                low_h = h
            feat_idx += 1

    x = _aspp_and_decoder(
        b, x, low_level,
        inplanes=320, low_level_ch=24, h=h, low_h=low_h,
        n_class=n_class, output_stride=output_stride, input_size=input_size,
    )
    return b.build([x])
