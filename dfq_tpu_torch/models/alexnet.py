"""AlexNet classifier (a copy of ``dfq_tpu/models/alexnet.py``; reference ``modeling/detection/nn/alexnet.py:16-48``,
the torchvision OWT variant kept in the reference's detection backbone zoo).

Node names equal the torch module paths so a torchvision
``alexnet-owt-*.pth`` checkpoint converts via
:func:`dfq_tpu_torch.models.common.load_torch_state_dict`. Dropouts are identity
at inference; the classifier flatten is C-major (torch ``x.view(N, -1)`` on
NCHW, reference ``alexnet.py:46``), realized as permute-to-NCHW + reshape.
"""

from __future__ import annotations

from dfq_tpu_torch.graph.ir import Graph, GraphBuilder


def alexnet(num_classes: int = 1000) -> Graph:
    b = GraphBuilder()
    x = b.input("data")
    # features (reference alexnet.py:19-32)
    x = b.conv("features.0", x, 3, 64, (11, 11), stride=(4, 4), padding=(2, 2), bias=True)
    x = b.relu("features.1", x)
    x = b.maxpool("features.2", x, window=(3, 3), stride=(2, 2))
    x = b.conv("features.3", x, 64, 192, (5, 5), padding=(2, 2), bias=True)
    x = b.relu("features.4", x)
    x = b.maxpool("features.5", x, window=(3, 3), stride=(2, 2))
    x = b.conv("features.6", x, 192, 384, (3, 3), padding=(1, 1), bias=True)
    x = b.relu("features.7", x)
    x = b.conv("features.8", x, 384, 256, (3, 3), padding=(1, 1), bias=True)
    x = b.relu("features.9", x)
    x = b.conv("features.10", x, 256, 256, (3, 3), padding=(1, 1), bias=True)
    x = b.relu("features.11", x)
    x = b.maxpool("features.12", x, window=(3, 3), stride=(2, 2))
    # classifier (reference alexnet.py:34-42); dropout = eval identity
    x = b.permute_nchw("flatten_perm", x, perm=(0, 1, 2, 3))
    x = b.reshape("flatten", x, shape=(-1,))
    x = b.dropout("classifier.0", x)
    x = b.linear("classifier.1", x, 256 * 6 * 6, 4096)
    x = b.relu("classifier.2", x)
    x = b.dropout("classifier.3", x)
    x = b.linear("classifier.4", x, 4096, 4096)
    x = b.relu("classifier.5", x)
    x = b.linear("classifier.6", x, 4096, num_classes)
    return b.build([x])
