"""ResNet-18 at 224x224 (He et al., arXiv:1512.03385; torchvision's
BasicBlock layout, the DFQ reference's second classifier): the frozen
graph."""

from .dfq.resnet import resnet18


def graph(cfg: dict):
    return resnet18(n_class=cfg["num_classes"])
