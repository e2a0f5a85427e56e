"""Backward BFS from a layer's inputs to the nearest BatchNorm per branch.

Behavioral contract: reference ``find_prev_bn``
(``utils/layer_transform.py:299-344``). Branch ids are
strings whose FIRST character identifies the top-level input branch and
whose LENGTH encodes walk depth (the reference extends ``bid`` with
``bid[0]`` per step, ``:337``). Connect types record whether a branch
reaches its BN through an elementwise add (``'add'`` /
``'add_relu'``/``'add_relu6'`` when a ReLU/ReLU6 follows the add), a
concat (``'cat'``), or a plain chain (``'one'``).

``targ_without_bn`` captures conv/linear layers encountered before any BN
(SSD detection heads — case d of range setting); keyed by top-level
branch id.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from dfq_tpu_torch.graph.ir import Graph


def find_prev_bn(
    graph: Graph,
    bn_module: Dict[str, object],
    relu_attached: Dict[str, str],
    bots: Tuple[str, ...],
):
    """Returns ``(bn_list, relu_attach_list, connect_type_list,
    targ_without_bn)`` where ``bn_list`` holds ``(bn_name, bid)``."""
    queue: List[Tuple[str, str]] = [(b, str(i)) for i, b in enumerate(bots)]
    type_tmp: Dict[str, str] = {str(i): "one" for i in range(len(bots))}
    targ_without_bn: Dict[str, Tuple[str, str]] = {}
    bn_list: List[Tuple[str, str]] = []
    relu_attach_list: List[str] = []
    connect_type_list: List[str] = []
    cat_add_found = False

    while queue:
        name, bid = queue.pop(0)
        node = graph[name]

        if node.op == "add":
            if name in relu_attached:
                type_tmp[bid] = f"add_{relu_attached[name]}"
            else:
                type_tmp[bid] = "add"
            cat_add_found = True
        elif node.op == "concat":
            type_tmp[bid] = "cat"
            cat_add_found = True
        elif not cat_add_found and node.op in ("conv", "linear"):
            if bid[0] in targ_without_bn:
                raise AssertionError(
                    "multiple conv/linear layers without BatchNorm on one "
                    "branch are not supported (reference layer_transform.py:330)"
                )
            targ_without_bn[bid[0]] = (node.op, name)

        if name not in bn_module:
            if node.op == "input":
                continue
            for nb in graph.bottoms(name):
                queue.append((nb, bid + bid[0]))
            type_tmp[bid + bid[0]] = type_tmp[bid]
        else:
            bn_list.append((name, bid))
            relu_attach_list.append(relu_attached.get(name, "none"))
            connect_type_list.append(type_tmp[bid])

    return bn_list, relu_attach_list, connect_type_list, targ_without_bn


def collect_bn_and_relu(graph: Graph, params) -> Tuple[Dict[str, object], Dict[str, str]]:
    """Scan the whole (folded) graph once, building the ``bn_module`` map
    (BN nodes carrying data-free stats) and the ``relu_attached`` map
    (node name -> 'relu'/'relu6' for the activation that directly follows
    it). Mirrors the incremental bookkeeping of the reference's single
    topological sweep (``utils/layer_transform.py:430-440``).
    """
    bn_module: Dict[str, object] = {}
    relu_attached: Dict[str, str] = {}
    for node in graph:
        if node.op == "bn" and "stat_std" in params.get(node.name, {}):
            bn_module[node.name] = node
            relu_attached.setdefault(node.name, "none")
        elif node.op == "relu":
            relu_attached[node.inputs[0]] = "relu"
        elif node.op == "relu6":
            relu_attached[node.inputs[0]] = "relu6"
    return bn_module, relu_attached
