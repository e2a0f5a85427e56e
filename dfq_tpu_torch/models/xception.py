"""Aligned Xception backbone for DeepLab-v3+ (a copy of
``dfq_tpu/models/xception.py``).

Behavioral contract: reference
``modeling/segmentation/backbone/xception.py``:

- ``SeparableConv2d``: explicit fixed_padding -> depthwise (valid,
  dilated) -> BN -> pointwise (``:17-31``) — note the BN sits between
  depthwise and pointwise with no activation;
- ``Block``: optional strided 1x1 skip+BN, a rep list of
  [relu, separable, BN] whose exact nn.Sequential indices (after the
  optional first-relu drop) define the checkpoint key layout
  (``:34-92``), residual add at the end;
- entry flow (conv1/conv2 + blocks 1-3; low-level tap = relu(block1), 128
  channels, ``:193-196``), 16 middle-flow blocks, exit flow block20 +
  conv3..5 at the exit dilations; os16: entry_block3_stride=2,
  exit dilations (1, 2) (``:103-111``).
"""

from __future__ import annotations

from dfq_tpu_torch.graph.ir import GraphBuilder


def _sep_conv(b, prefix, x, inp, out, *, stride=1, dilation=1):
    """SeparableConv2d (xception.py:17-31): fixed_padding + valid dw +
    BN + pw."""
    d = dilation
    pad = d  # k=3: pad_total = 2d, symmetric
    x = b.pad(f"{prefix}.fixpad", x, pads=(pad, pad, pad, pad))
    x = b.conv(
        f"{prefix}.conv1", x, inp, inp, (3, 3), stride=(stride, stride),
        padding=(0, 0), dilation=(d, d), groups=inp,
    )
    x = b.bn(f"{prefix}.bn", x, inp)
    x = b.conv(f"{prefix}.pointwise", x, inp, out, (1, 1))
    return x


def _block(
    b, prefix, x, inplanes, planes, reps, *, stride=1, dilation=1,
    start_with_relu=True, grow_first=True, is_last=False,
):
    """Xception Block (xception.py:34-92). Node names follow the
    nn.Sequential indices of the final rep list."""
    inp_node = x
    # build the rep op list exactly as the reference does
    ops = []  # ("relu",) | ("sep", cin, cout, stride, dilation) | ("bn", ch)
    filters = inplanes
    if grow_first:
        ops += [("relu",), ("sep", inplanes, planes, 1, dilation), ("bn", planes)]
        filters = planes
    for _ in range(reps - 1):
        ops += [("relu",), ("sep", filters, filters, 1, dilation), ("bn", filters)]
    if not grow_first:
        ops += [("relu",), ("sep", inplanes, planes, 1, dilation), ("bn", planes)]
    if stride != 1:
        ops += [("relu",), ("sep", planes, planes, 2, 1), ("bn", planes)]
    if stride == 1 and is_last:
        ops += [("relu",), ("sep", planes, planes, 1, 1), ("bn", planes)]
    if not start_with_relu:
        ops = ops[1:]

    y = x
    for idx, op in enumerate(ops):
        name = f"{prefix}.rep.{idx}"
        if op[0] == "relu":
            y = b.relu(name, y)
        elif op[0] == "sep":
            _, cin, cout, st, d = op
            y = _sep_conv(b, name, y, cin, cout, stride=st, dilation=d)
        else:
            y = b.bn(name, y, op[1])

    if planes != inplanes or stride != 1:
        sc = b.conv(
            f"{prefix}.skip", inp_node, inplanes, planes, (1, 1),
            stride=(stride, stride),
        )
        sc = b.bn(f"{prefix}.skipbn", sc, planes)
    else:
        sc = inp_node
    return b.add(f"{prefix}.add", y, sc)


def xception_backbone(b: GraphBuilder, x: str, output_stride: int = 16):
    """Returns (x_2048ch, low_level_128ch)."""
    if output_stride == 16:
        entry3_stride, mid_dil, exit_dil = 2, 1, (1, 2)
    else:
        entry3_stride, mid_dil, exit_dil = 1, 2, (2, 4)

    p = "backbone"
    x = b.conv(f"{p}.conv1", x, 3, 32, (3, 3), stride=(2, 2), padding=(1, 1))
    x = b.bn(f"{p}.bn1", x, 32)
    x = b.relu(f"{p}.relu1", x)
    x = b.conv(f"{p}.conv2", x, 32, 64, (3, 3), padding=(1, 1))
    x = b.bn(f"{p}.bn2", x, 64)
    x = b.relu(f"{p}.relu2", x)

    x = _block(b, f"{p}.block1", x, 64, 128, 2, stride=2, start_with_relu=False)
    x = b.relu(f"{p}.block1_relu", x)
    low_level = x
    x = _block(b, f"{p}.block2", x, 128, 256, 2, stride=2,
               start_with_relu=False, grow_first=True)
    x = _block(b, f"{p}.block3", x, 256, 728, 2, stride=entry3_stride,
               start_with_relu=True, grow_first=True, is_last=True)

    for i in range(4, 20):  # middle flow
        x = _block(b, f"{p}.block{i}", x, 728, 728, 3, stride=1,
                   dilation=mid_dil, start_with_relu=True, grow_first=True)

    x = _block(b, f"{p}.block20", x, 728, 1024, 2, stride=1,
               dilation=exit_dil[0], start_with_relu=True, grow_first=False,
               is_last=True)
    x = b.relu(f"{p}.relu20", x)
    x = _sep_conv(b, f"{p}.conv3", x, 1024, 1536, dilation=exit_dil[1])
    x = b.bn(f"{p}.bn3", x, 1536)
    x = b.relu(f"{p}.relu3", x)
    x = _sep_conv(b, f"{p}.conv4", x, 1536, 1536, dilation=exit_dil[1])
    x = b.bn(f"{p}.bn4", x, 1536)
    x = b.relu(f"{p}.relu4", x)
    x = _sep_conv(b, f"{p}.conv5", x, 1536, 2048, dilation=exit_dil[1])
    x = b.bn(f"{p}.bn5", x, 2048)
    x = b.relu(f"{p}.relu5", x)
    return x, low_level
