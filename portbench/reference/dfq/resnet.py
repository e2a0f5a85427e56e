"""ResNet-18 as a graph IR builder (torchvision BasicBlock layout; a frozen copy of
``dfq_tpu_torch/models/resnet.py``).

The reference evaluates ``torchvision.models.resnet18(pretrained=True)``
(its ``main_cls.py:79-81``). Node names follow torchvision
module paths so a torchvision state_dict converts directly.
"""

from __future__ import annotations

from .ir import Graph, GraphBuilder

_LAYERS = [  # (layer name, out_ch, stride of first block)
    ("layer1", 64, 1),
    ("layer2", 128, 2),
    ("layer3", 256, 2),
    ("layer4", 512, 2),
]


def resnet18(n_class: int = 1000) -> Graph:
    b = GraphBuilder()
    x = b.input("data")
    x = b.conv("conv1", x, 3, 64, (7, 7), stride=(2, 2), padding=(3, 3))
    x = b.bn("bn1", x, 64)
    x = b.relu("relu", x)
    x = b.maxpool("maxpool", x, window=(3, 3), stride=(2, 2), padding=(1, 1))

    in_ch = 64
    for lname, out_ch, first_stride in _LAYERS:
        for i in range(2):
            stride = first_stride if i == 0 else 1
            prefix = f"{lname}.{i}"
            block_in = x
            x = b.conv(
                f"{prefix}.conv1", x, in_ch, out_ch, (3, 3),
                stride=(stride, stride), padding=(1, 1),
            )
            x = b.bn(f"{prefix}.bn1", x, out_ch)
            x = b.relu(f"{prefix}.relu1", x)
            x = b.conv(f"{prefix}.conv2", x, out_ch, out_ch, (3, 3), padding=(1, 1))
            x = b.bn(f"{prefix}.bn2", x, out_ch)
            if stride != 1 or in_ch != out_ch:
                sc = b.conv(
                    f"{prefix}.downsample.0", block_in, in_ch, out_ch, (1, 1),
                    stride=(stride, stride),
                )
                sc = b.bn(f"{prefix}.downsample.1", sc, out_ch)
            else:
                sc = block_in
            x = b.add(f"{prefix}.add", sc, x)
            x = b.relu(f"{prefix}.relu2", x)
            in_ch = out_ch

    x = b.global_mean("avgpool", x)
    x = b.linear("fc", x, 512, n_class)
    return b.build([x])
