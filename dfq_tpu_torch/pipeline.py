"""End-to-end DFQ pipeline: FP32 graph + params -> quantized model.

Functional equivalent of the reference entry-script flow
(``main_cls.py:116-198``):

    relu6->relu swap -> BN fold -> [equalize] -> [absorb] -> [clip]
    -> [correct] -> weight quant -> activation ranges (data-free or
    distilled) -> eval with fake-quant  (or lower to true int8)

All steps are pure; the returned :class:`PreparedModel` carries
everything the executor / int8 engine needs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from dfq_tpu_torch.graph.ir import Graph
from dfq_tpu_torch.passes.absorb import bias_absorption
from dfq_tpu_torch.passes.clip import clip_weights
from dfq_tpu_torch.passes.correct import bias_correction
from dfq_tpu_torch.passes.equalize import cross_layer_equalization
from dfq_tpu_torch.passes.fold_bn import fold_batchnorm
from dfq_tpu_torch.passes.range_setter import set_quant_ranges
from dfq_tpu_torch.passes.relations import create_relations
from dfq_tpu_torch.passes.weight_quant import quantize_layer_weights


@dataclasses.dataclass
class QuantConfig:
    """Mirrors the reference CLI flags (``main_cls.py:23-41``)."""

    quantize: bool = True
    relu: bool = False  # ReLU6 -> ReLU swap
    equalize: bool = False
    absorption: bool = False
    correction: bool = False
    clip_weight: bool = False
    distill_range: bool = False  # ranges from distilled data, not BN stats
    # reference --trainable (main_cls.py:33): weights fake-quantized
    # per-forward (QuantConv2d, utils/quantize.py:208-233) instead of
    # pre-quantized once; executor runs with weight_bits=bits_weight
    trainable: bool = False
    bits_weight: int = 8
    bits_activation: int = 8
    bits_bias: int = 8
    signed: bool = False  # symmetric weight quant (ncnn / Int8' regime)
    per_channel: bool = False  # per-channel weight quant (beyond reference)
    delete_single: bool = False  # SSD relation filtering
    is_detection: bool = False  # input range [-1, 1]

    def __post_init__(self):
        # flag invariants enforced by the reference (main_cls.py:74-75)
        if self.equalize and not self.relu:
            raise ValueError("equalization requires the ReLU6->ReLU swap (--relu)")
        if self.absorption and not self.equalize:
            raise ValueError("bias absorption requires equalization")
        if self.trainable and self.distill_range:
            # the reference's module_dict elif chain (main_cls.py:119-124)
            # makes these regimes mutually exclusive
            raise ValueError("trainable and distill_range are exclusive regimes")


@dataclasses.dataclass
class PreparedModel:
    graph: Graph
    params: Dict[str, Dict[str, Any]]  # weights fake-quantized (sim regime)
    act_ranges: Dict[str, Tuple[float, float]]
    cfg: QuantConfig
    # post-pass, pre-weight-quant params: the input to true-int8 lowering
    params_fp: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)


def prepare(
    graph: Graph,
    params: Dict[str, Dict[str, Any]],
    cfg: Optional[QuantConfig] = None,
) -> PreparedModel:
    cfg = cfg or QuantConfig()

    if cfg.relu:
        graph = graph.map_ops({"relu6": "relu"})

    graph, params = fold_batchnorm(graph, params)

    relations = None
    if cfg.equalize or cfg.distill_range:
        relations = create_relations(graph, delete_single=cfg.delete_single)
        if cfg.equalize:
            relations = [r for r in relations if r.bn is not None]
            params = cross_layer_equalization(
                graph, params, relations, signed=cfg.signed
            )

    if cfg.absorption:
        params = bias_absorption(graph, params, relations)

    if cfg.clip_weight:
        params = clip_weights(graph, params)

    if cfg.correction:
        params = bias_correction(
            graph, params, bits_weight=cfg.bits_weight, signed=cfg.signed
        )

    params_fp = {k: dict(v) for k, v in params.items()}
    act_ranges: Dict[str, Tuple[float, float]] = {}
    if cfg.quantize:
        if not cfg.trainable:
            # trainable regime skips the one-shot weight quant
            # (main_cls.py:180-182) — the executor fake-quants
            # per-forward via weight_bits instead
            params = quantize_layer_weights(
                graph,
                params,
                bits_weight=cfg.bits_weight,
                bits_bias=cfg.bits_bias,
                signed=cfg.signed,
                per_channel=cfg.per_channel,
            )
        if not cfg.distill_range:
            act_ranges = set_quant_ranges(
                graph, params, is_detection=cfg.is_detection
            )
        # distilled ranges: the entry points set them after prepare, with
        # dfq_tpu_torch.calib.calibrate_ranges on distilled batches

    return PreparedModel(
        graph=graph,
        params=params,
        act_ranges=act_ranges,
        cfg=cfg,
        params_fp=params_fp,
    )
