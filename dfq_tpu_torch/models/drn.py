"""DRN-D-54 backbone for DeepLab-v3+ (a copy of ``dfq_tpu/models/drn.py``).

Behavioral contract: reference
``modeling/segmentation/backbone/drn.py`` (``drn_d_54``, ``:377-384``):
arch 'D' (conv stem + plain conv layers 1/2/7/8), Bottleneck layers 3-6
with the DRN dilation schedule (layer5 d2, layer6 d4, degridding
layers 7/8 at d2/d1), channels (16,32,64,128,256,512,512,512), blocks
[1,1,3,4,6,3,1,1]. Overall stride 8; low-level tap = layer3 output
(256 ch, ``drn.py:219-220``). DeepLab forces output_stride 8 for DRN
(``deeplab.py:13-14``).
"""

from __future__ import annotations

from dfq_tpu_torch.graph.ir import GraphBuilder


def _conv_layers(b, prefix, x, inp, ch, convs, *, stride=1, dilation=1):
    for i in range(convs):
        st = stride if i == 0 else 1
        d = dilation
        x = b.conv(
            f"{prefix}.{3 * i}", x, inp, ch, (3, 3), stride=(st, st),
            padding=(d, d), dilation=(d, d),
        )
        x = b.bn(f"{prefix}.{3 * i + 1}", x, ch)
        x = b.relu(f"{prefix}.{3 * i + 2}", x)
        inp = ch
    return x, ch


def _bottleneck(b, prefix, x, inp, planes, *, stride=1, dilation=(1, 1),
                downsample=False):
    out_ch = planes * 4
    block_in = x
    y = b.conv(f"{prefix}.conv1", x, inp, planes, (1, 1))
    y = b.bn(f"{prefix}.bn1", y, planes)
    y = b.relu(f"{prefix}.relu1", y)
    d = dilation[1]
    y = b.conv(
        f"{prefix}.conv2", y, planes, planes, (3, 3), stride=(stride, stride),
        padding=(d, d), dilation=(d, d),
    )
    y = b.bn(f"{prefix}.bn2", y, planes)
    y = b.relu(f"{prefix}.relu2", y)
    y = b.conv(f"{prefix}.conv3", y, planes, out_ch, (1, 1))
    y = b.bn(f"{prefix}.bn3", y, out_ch)
    if downsample:
        sc = b.conv(
            f"{prefix}.downsample.0", block_in, inp, out_ch, (1, 1),
            stride=(stride, stride),
        )
        sc = b.bn(f"{prefix}.downsample.1", sc, out_ch)
    else:
        sc = block_in
    y = b.add(f"{prefix}.add", sc, y)
    return b.relu(f"{prefix}.relu3", y), out_ch


def _res_layer(b, prefix, x, inp, planes, blocks, *, stride=1, dilation=1,
               new_level=True):
    if dilation == 1:
        d_first = (1, 1)
    else:
        d_first = (dilation // 2 if new_level else dilation, dilation)
    down = stride != 1 or inp != planes * 4
    x, inp = _bottleneck(
        b, f"{prefix}.0", x, inp, planes, stride=stride, dilation=d_first,
        downsample=down,
    )
    for i in range(1, blocks):
        x, inp = _bottleneck(
            b, f"{prefix}.{i}", x, inp, planes, dilation=(dilation, dilation)
        )
    return x, inp


def drn_d_54_backbone(b: GraphBuilder, x: str):
    """Returns (x_512ch at stride 8, low_level_256ch at stride 4)."""
    p = "backbone"
    x = b.conv(f"{p}.layer0.0", x, 3, 16, (7, 7), padding=(3, 3))
    x = b.bn(f"{p}.layer0.1", x, 16)
    x = b.relu(f"{p}.layer0.2", x)
    x, ch = _conv_layers(b, f"{p}.layer1", x, 16, 16, 1)
    x, ch = _conv_layers(b, f"{p}.layer2", x, 16, 32, 1, stride=2)
    x, ch = _res_layer(b, f"{p}.layer3", x, 32, 64, 3, stride=2)
    low_level = x  # 256 ch
    x, ch = _res_layer(b, f"{p}.layer4", x, ch, 128, 4, stride=2)
    x, ch = _res_layer(b, f"{p}.layer5", x, ch, 256, 6, dilation=2,
                       new_level=False)
    x, ch = _res_layer(b, f"{p}.layer6", x, ch, 512, 3, dilation=4,
                       new_level=False)
    x, ch = _conv_layers(b, f"{p}.layer7", x, 2048, 512, 1, dilation=2)
    x, ch = _conv_layers(b, f"{p}.layer8", x, 512, 512, 1, dilation=1)
    return x, low_level
