"""Explicit graph IR for CNN inference models.

The PyTorch port's own copy of ``dfq_tpu/graph/ir.py`` (pure Python, kept
identical so both packages see the same graphs): an ordered (topological)
dict of typed nodes with explicit producers. Every quantization pass is a
pure function over ``(Graph, params)``; the int8 engine
(``dfq_tpu_torch/engine/int8_fused.py``) interprets the graph.

Conventions
-----------
- Activations are NHWC (the JAX package's layout, kept at every public
  function of the port); conv weights are stored OIHW in the params dict
  and linear weights ``[out, in]``.
- ``params`` is ``{node_name: {"weight": ..., "bias": ..., ...}}``.
- BatchNorm nodes carry ``gamma/beta/mean/var``; after folding
  (``dfq_tpu/passes/fold_bn.py``) they become ``identity`` ops that retain
  ``stat_std``/``stat_mean`` — the data-free statistics (reference
  ``fake_weight``/``fake_bias``, ``utils/layer_transform.py:264-265``).
- Quantization sites: every input edge that the reference would guard with
  a ``QuantMeasure`` gets a string key ``"<node>:in<i>"`` (see
  :func:`quant_sites`).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# Ops whose inputs are fake-quantized in the reference pipeline:
# conv/linear via the Q-layer input QuantMeasure (utils/quantize.py:245-251),
# tensor ops via CustomTensorOP (utils/layer_transform.py:16-118).
QUANTIZED_INPUT_OPS = {
    "conv": 1,  # one site: its input
    "linear": 1,
    "add": 2,  # both operands
    "concat": None,  # one site per operand
    "global_mean": 1,
    "interpolate": 1,
    "softmax": 1,
}

# Ops a relation walk may pass through (reference utils/relation.py:42-43;
# note Dropout is NOT walkable there, so relations stop at decoder dropouts).
PASSTHROUGH_OPS = {"bn", "relu", "avgpool", "pad", "global_mean"}


@dataclasses.dataclass
class Node:
    name: str
    op: str
    inputs: Tuple[str, ...]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "Node":
        return dataclasses.replace(self, **kw)


class Graph:
    """Ordered collection of nodes in topological order."""

    def __init__(self, nodes: Iterable[Node], outputs: Sequence[str]):
        self.nodes: "OrderedDict[str, Node]" = OrderedDict()
        for n in nodes:
            if n.name in self.nodes:
                raise ValueError(f"duplicate node name {n.name!r}")
            self.nodes[n.name] = n
        self.outputs: Tuple[str, ...] = tuple(outputs)
        self._validate()

    def _validate(self) -> None:
        seen = set()
        for n in self.nodes.values():
            for inp in n.inputs:
                if inp not in seen:
                    raise ValueError(
                        f"node {n.name!r} consumes {inp!r} before it is defined"
                    )
            seen.add(n.name)
        for o in self.outputs:
            if o not in self.nodes:
                raise ValueError(f"unknown output {o!r}")

    def __iter__(self):
        return iter(self.nodes.values())

    def __getitem__(self, name: str) -> Node:
        return self.nodes[name]

    def __contains__(self, name: str) -> bool:
        return name in self.nodes

    def __len__(self) -> int:
        return len(self.nodes)

    def bottoms(self, name: str) -> Tuple[str, ...]:
        """Producer names of a node (reference ``log.getBottoms()``)."""
        return self.nodes[name].inputs

    def consumers(self, name: str) -> List[str]:
        return [n.name for n in self.nodes.values() if name in n.inputs]

    def fanout(self) -> Dict[str, int]:
        """Number of consumers per node (reference ``top_counter``,
        ``utils/relation.py:50-58``)."""
        count: Dict[str, int] = {}
        for n in self.nodes.values():
            for inp in n.inputs:
                count[inp] = count.get(inp, 0) + 1
        return count

    def replace_node(self, name: str, node: Node) -> "Graph":
        nodes = [node if n.name == name else n for n in self.nodes.values()]
        return Graph(nodes, self.outputs)

    def map_ops(self, mapping: Dict[str, str]) -> "Graph":
        """Return a graph with op types swapped (e.g. relu6 -> relu; the
        reference's ``module_dict[0]`` swap, ``main_cls.py:126-127``)."""
        nodes = [
            n.replace(op=mapping[n.op]) if n.op in mapping else n
            for n in self.nodes.values()
        ]
        return Graph(nodes, self.outputs)

    def input_names(self) -> List[str]:
        return [n.name for n in self.nodes.values() if n.op == "input"]

    def summary(self) -> str:
        """Tabular layer listing (PyTransformer ``summary`` parity,
        reference ``main_cls.py:129``)."""
        lines = [f"{'name':<40} {'op':<12} {'attrs'}"]
        for n in self.nodes.values():
            attrs = {
                k: v
                for k, v in n.attrs.items()
                if k in ("in_ch", "out_ch", "kernel", "stride", "groups",
                         "dilation", "in_f", "out_f")
            }
            lines.append(f"{n.name:<40} {n.op:<12} {attrs}")
        return "\n".join(lines)

    def to_dot(self) -> str:
        """Graphviz dot source (PyTransformer ``visualize`` parity,
        reference ``main_cls.py:130``)."""
        lines = ["digraph G {", "  rankdir=TB;", '  node [shape=box, fontsize=10];']
        for n in self.nodes.values():
            color = {
                "conv": "lightblue", "linear": "lightblue", "bn": "lightyellow",
                "add": "lightpink", "concat": "lightpink",
            }.get(n.op, "white")
            lines.append(
                f'  "{n.name}" [label="{n.name}\\n{n.op}", '
                f'style=filled, fillcolor={color}];'
            )
            for inp in n.inputs:
                lines.append(f'  "{inp}" -> "{n.name}";')
        lines.append("}")
        return "\n".join(lines)


def quant_sites(graph: Graph) -> List[str]:
    """All activation-quantizer site keys in topological order.

    A site ``"<node>:in<i>"`` fake-quantizes the i-th input of the node.
    Mirrors which activations the reference quantizes: Q-layer inputs plus
    the traced tensor ops add/cat/mean/interpolate/softmax
    (``utils/layer_transform.py:10-14``, with 'pad' ignored at
    ``utils/layer_transform.py:152``).
    """
    sites: List[str] = []
    for node in graph:
        if node.op not in QUANTIZED_INPUT_OPS:
            continue
        n_sites = QUANTIZED_INPUT_OPS[node.op]
        if n_sites is None:
            n_sites = len(node.inputs)
        for i in range(n_sites):
            sites.append(f"{node.name}:in{i}")
    return sites


def node_sites(node: Node) -> List[str]:
    if node.op not in QUANTIZED_INPUT_OPS:
        return []
    n_sites = QUANTIZED_INPUT_OPS[node.op]
    if n_sites is None:
        n_sites = len(node.inputs)
    return [f"{node.name}:in{i}" for i in range(n_sites)]


class GraphBuilder:
    """Convenience constructor of a :class:`Graph`.

    Each method appends a node and returns its name so calls chain
    naturally::

        b = GraphBuilder()
        x = b.input("data")
        x = b.conv("stem", x, stride=2, padding=1)
        ...
        graph = b.build([x])
    """

    def __init__(self) -> None:
        self._nodes: List[Node] = []

    def _add(self, name: str, op: str, inputs: Sequence[str], **attrs) -> str:
        self._nodes.append(Node(name, op, tuple(inputs), dict(attrs)))
        return name

    def input(self, name: str = "data", **attrs) -> str:
        return self._add(name, "input", (), **attrs)

    def conv(
        self,
        name: str,
        x: str,
        in_ch: int,
        out_ch: int,
        kernel: Tuple[int, int],
        *,
        stride: Tuple[int, int] = (1, 1),
        padding: Tuple[int, int] = (0, 0),
        dilation: Tuple[int, int] = (1, 1),
        groups: int = 1,
        bias: bool = False,
    ) -> str:
        return self._add(
            name,
            "conv",
            (x,),
            in_ch=in_ch,
            out_ch=out_ch,
            kernel=tuple(kernel),
            stride=tuple(stride),
            padding=tuple(padding),
            dilation=tuple(dilation),
            groups=groups,
            bias=bias,
        )

    def linear(
        self, name: str, x: str, in_f: int, out_f: int, *, bias: bool = True
    ) -> str:
        return self._add(name, "linear", (x,), in_f=in_f, out_f=out_f, bias=bias)

    def bn(self, name: str, x: str, ch: int, *, eps: float = 1e-5) -> str:
        return self._add(name, "bn", (x,), ch=ch, eps=eps)

    def relu(self, name: str, x: str) -> str:
        return self._add(name, "relu", (x,))

    def relu6(self, name: str, x: str) -> str:
        return self._add(name, "relu6", (x,))

    def add(self, name: str, a: str, b: str) -> str:
        return self._add(name, "add", (a, b))

    def concat(self, name: str, xs: Sequence[str], *, axis: int = -1) -> str:
        # axis is in NHWC terms; channel concat = -1
        return self._add(name, "concat", tuple(xs), axis=axis)

    def global_mean(self, name: str, x: str) -> str:
        """Spatial global average -> [N, C] (reference ``torch.mean`` over
        flattened HxW, ``modeling/classification/MobileNetV2.py:112``).
        Input-quantized (the reference traces ``torch.mean``)."""
        return self._add(name, "global_mean", (x,))

    def global_pool(self, name: str, x: str) -> str:
        """Spatial global average keeping dims -> [N, 1, 1, C] (reference
        ``nn.AdaptiveAvgPool2d((1,1))``, ``aspp.py:66``). NOT a quantizer
        site: modules are not traced tensor ops in the reference."""
        return self._add(name, "global_pool", (x,))

    def avgpool(
        self,
        name: str,
        x: str,
        *,
        window: Tuple[int, int],
        stride: Optional[Tuple[int, int]] = None,
        padding: Tuple[int, int] = (0, 0),
    ) -> str:
        return self._add(
            name,
            "avgpool",
            (x,),
            window=tuple(window),
            stride=tuple(stride or window),
            padding=tuple(padding),
        )

    def maxpool(
        self,
        name: str,
        x: str,
        *,
        window: Tuple[int, int],
        stride: Optional[Tuple[int, int]] = None,
        padding: Tuple[int, int] = (0, 0),
    ) -> str:
        return self._add(
            name,
            "maxpool",
            (x,),
            window=tuple(window),
            stride=tuple(stride or window),
            padding=tuple(padding),
        )

    def pad(self, name: str, x: str, *, pads: Tuple[int, int, int, int]) -> str:
        """Spatial padding (top, bottom, left, right)."""
        return self._add(name, "pad", (x,), pads=tuple(pads))

    def interpolate(
        self,
        name: str,
        x: str,
        *,
        size: Optional[Tuple[int, int]] = None,
        scale: Optional[float] = None,
        mode: str = "bilinear",
        align_corners: bool = True,
    ) -> str:
        return self._add(
            name,
            "interpolate",
            (x,),
            size=tuple(size) if size else None,
            scale=scale,
            mode=mode,
            align_corners=align_corners,
        )

    def softmax(self, name: str, x: str, *, axis: int = -1) -> str:
        return self._add(name, "softmax", (x,), axis=axis)

    def dropout(self, name: str, x: str) -> str:
        return self._add(name, "dropout", (x,))

    def l2norm(self, name: str, x: str, ch: int, *, initial_scale: float = 20.0) -> str:
        """Channel L2-normalize then multiply a learnable per-channel scale
        (reference ``ScaledL2Norm``,
        ``modeling/detection/nn/scaled_l2_norm.py:6-20``). A module in the
        reference, so not a traced-tensor-op quantizer site."""
        return self._add(name, "l2norm", (x,), ch=ch, initial_scale=initial_scale)

    def identity(self, name: str, x: str) -> str:
        return self._add(name, "identity", (x,))

    def reshape(self, name: str, x: str, *, shape: Tuple[int, ...]) -> str:
        """Reshape trailing dims; -1 allowed. Batch dim preserved."""
        return self._add(name, "reshape", (x,), shape=tuple(shape))

    def permute_nchw(self, name: str, x: str, *, perm: Tuple[int, ...]) -> str:
        return self._add(name, "permute_nchw", (x,), perm=tuple(perm))

    def build(self, outputs: Sequence[str]) -> Graph:
        return Graph(self._nodes, outputs)
