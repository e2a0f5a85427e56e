"""Equalizable layer-pair discovery.

Behavioral contract: reference ``create_relation``
(``utils/relation.py:30-94``): starting from every target
(conv/linear) node, walk producers upward through single-input,
fanout-1 chains of {BN, ReLU, AvgPool, pad, global-mean} nodes; if
another target layer is reached, the two form an equalization relation,
recording the BN between them (closest to the first layer). ReLU6 is
deliberately NOT walkable — equalization requires the ReLU6->ReLU swap
(``main_cls.py:74``).

``delete_single=True`` keeps only chained relation groups (>=2 links),
used for SSD detection heads (``main_ssd.py:236``,
``utils/relation.py:70-92``).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from .ir import Graph

_WALKABLE = {"bn", "relu", "avgpool", "pad", "global_mean"}
_TARGET = {"conv", "linear"}


@dataclasses.dataclass
class Relation:
    """An equalizable pair: ``first -> (bn) -> ... -> second``."""

    first: str
    second: str
    bn: Optional[str]
    scale: Optional[np.ndarray] = None  # cumulative equalization scale S

    def accumulate_scale(self, s: np.ndarray) -> None:
        self.scale = s.copy() if self.scale is None else self.scale * s


def create_relations(
    graph: Graph, delete_single: bool = False
) -> List[Relation]:
    fanout = graph.fanout()

    def find_prev(name: str) -> Tuple[Optional[str], Optional[str]]:
        bots = graph.bottoms(name)
        last_bn = None
        while (
            len(bots) == 1
            and graph[bots[0]].op != "input"
            and fanout.get(bots[0], 0) == 1
        ):
            bot = graph[bots[0]]
            if bot.op == "bn":
                last_bn = bot.name
            if bot.op in _TARGET:
                return bot.name, last_bn
            if bot.op not in _WALKABLE:
                return None, None
            bots = graph.bottoms(bot.name)
        return None, None

    relation_dict: "OrderedDict[str, Relation]" = OrderedDict()
    for node in graph:
        if node.op not in _TARGET:
            continue
        prev, bn = find_prev(node.name)
        if prev in relation_dict:
            # three targets in an unbranched chain: the reference drops the
            # middle pair to avoid overlapping updates (utils/relation.py:64-65)
            relation_dict.pop(prev)
        elif prev is not None:
            relation_dict[prev] = Relation(prev, node.name, bn)

    relations = list(relation_dict.values())
    if not delete_single:
        return relations

    groups: List[List[Relation]] = []
    for rel in relations:
        gi = -1
        for idx, group in enumerate(groups):
            if any(rel.first == r.second for r in group):
                gi = idx
                break
        if gi >= 0:
            groups[gi].append(rel)
        else:
            groups.append([rel])
    out: List[Relation] = []
    for group in groups:
        if len(group) > 1:
            out.extend(group)
    return out
