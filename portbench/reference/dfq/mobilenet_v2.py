"""MobileNetV2 (tonylins variant) as a graph IR.

Mirrors the reference architecture at
``modeling/classification/MobileNetV2.py`` — inverted
residuals (``:27-65``), width settings (``:74-83``), global ``torch.mean``
pooling (``:112``) — with node names equal to torch module paths so the
published checkpoint (``mobilenetv2_1.0-f2a8633.pth.tar``) converts
key-for-key via :func:`dfq_tpu_torch.models.common.load_torch_state_dict`.
"""

from __future__ import annotations

import math

from .ir import Graph, GraphBuilder

# (expand_ratio t, out_channels c, repeats n, stride s)
_SETTINGS = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def _make_divisible(x: float, by: int = 8) -> int:
    return int(math.ceil(x / by) * by)


def mobilenet_v2(
    n_class: int = 1000, width_mult: float = 1.0, relu6: bool = True
) -> Graph:
    """Build the MobileNetV2 classification graph.

    ``relu6=False`` builds with plain ReLU (the reference's ``--relu``
    ReLU6->ReLU swap, ``main_cls.py:126-127``); :meth:`Graph.map_ops` can
    also apply the swap after the fact.
    """
    b = GraphBuilder()
    act = b.relu6 if relu6 else b.relu

    x = b.input("data")
    in_ch = 32
    x = b.conv("features.0.0", x, 3, in_ch, (3, 3), stride=(2, 2), padding=(1, 1))
    x = b.bn("features.0.1", x, in_ch)
    x = act("features.0.2", x)

    feat_idx = 1
    for t, c, n, s in _SETTINGS:
        out_ch = _make_divisible(c * width_mult) if t > 1 else c
        for i in range(n):
            stride = s if i == 0 else 1
            prefix = f"features.{feat_idx}.conv"
            hidden = int(in_ch * t)
            block_in = x
            if t == 1:
                # dw 3x3 -> bn -> act -> pw-linear 1x1 -> bn
                x = b.conv(
                    f"{prefix}.0", x, hidden, hidden, (3, 3),
                    stride=(stride, stride), padding=(1, 1), groups=hidden,
                )
                x = b.bn(f"{prefix}.1", x, hidden)
                x = act(f"{prefix}.2", x)
                x = b.conv(f"{prefix}.3", x, hidden, out_ch, (1, 1))
                x = b.bn(f"{prefix}.4", x, out_ch)
            else:
                # pw 1x1 -> bn -> act -> dw 3x3 -> bn -> act -> pw 1x1 -> bn
                x = b.conv(f"{prefix}.0", x, in_ch, hidden, (1, 1))
                x = b.bn(f"{prefix}.1", x, hidden)
                x = act(f"{prefix}.2", x)
                x = b.conv(
                    f"{prefix}.3", x, hidden, hidden, (3, 3),
                    stride=(stride, stride), padding=(1, 1), groups=hidden,
                )
                x = b.bn(f"{prefix}.4", x, hidden)
                x = act(f"{prefix}.5", x)
                x = b.conv(f"{prefix}.6", x, hidden, out_ch, (1, 1))
                x = b.bn(f"{prefix}.7", x, out_ch)
            if stride == 1 and in_ch == out_ch:
                x = b.add(f"features.{feat_idx}.add", block_in, x)
            in_ch = out_ch
            feat_idx += 1

    last_ch = _make_divisible(1280 * width_mult) if width_mult > 1.0 else 1280
    x = b.conv("features.18.0", x, in_ch, last_ch, (1, 1))
    x = b.bn("features.18.1", x, last_ch)
    x = act("features.18.2", x)

    x = b.global_mean("pool", x)
    x = b.linear("classifier", x, last_ch, n_class)
    return b.build([x])
