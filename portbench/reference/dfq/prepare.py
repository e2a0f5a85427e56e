"""The DFQ pipeline (``dfq_tpu_torch/pipeline.py``, frozen) for the data-free
regimes the benchmark's configurations state: ReLU6 -> ReLU swap, BN fold,
equalization, bias absorption, bias correction, weight quantization and
BN-derived activation ranges."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from .absorb import bias_absorption
from .correct import bias_correction
from .equalize import cross_layer_equalization
from .fold_bn import fold_batchnorm
from .ir import Graph
from .range_setter import set_quant_ranges
from .relations import create_relations
from .weight_quant import quantize_layer_weights


@dataclasses.dataclass
class QuantConfig:
    relu: bool = False
    equalize: bool = False
    absorption: bool = False
    correction: bool = False
    bits_weight: int = 8
    bits_activation: int = 8
    bits_bias: int = 8
    delete_single: bool = False
    is_detection: bool = False


@dataclasses.dataclass
class Prepared:
    graph: Graph
    params_fp: Dict[str, Dict[str, Any]]  # post-pass, pre-weight-quant
    act_ranges: Dict[str, Tuple[float, float]]
    cfg: QuantConfig


def prepare(graph: Graph, params: Dict[str, Dict[str, Any]], cfg: QuantConfig) -> Prepared:
    if cfg.relu:
        graph = graph.map_ops({"relu6": "relu"})
    graph, params = fold_batchnorm(graph, params)
    if cfg.equalize:
        relations = create_relations(graph, delete_single=cfg.delete_single)
        relations = [r for r in relations if r.bn is not None]
        params = cross_layer_equalization(graph, params, relations, signed=False)
        if cfg.absorption:
            params = bias_absorption(graph, params, relations)
    if cfg.correction:
        params = bias_correction(graph, params, bits_weight=cfg.bits_weight, signed=False)
    params_fp = {k: dict(v) for k, v in params.items()}
    quantized = quantize_layer_weights(graph, params, bits_weight=cfg.bits_weight,
                                       bits_bias=cfg.bits_bias, signed=False)
    act_ranges = set_quant_ranges(graph, quantized, is_detection=cfg.is_detection)
    return Prepared(graph, params_fp, act_ranges, cfg)
