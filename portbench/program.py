"""The system under test, set up from a configuration: the port's model
graph, its DFQ pipeline (``pipeline.prepare``), int8 lowering
(``engine.lower_int8``) and fused engine (``Int8FusedNet``), with the
configuration's task on top. Every import of the program is here and in
``tasks/``."""

from __future__ import annotations

import importlib
import time
from typing import Dict

import torch

from portbench import seeded


def load(dotted: str):
    """``"package.module:attr"`` -> the attribute."""
    mod, _, attr = dotted.partition(":")
    return getattr(importlib.import_module(mod), attr)


class Program:
    """``split`` holds the seconds of each set-up stage."""

    def __init__(self, cfg: dict, params: seeded.Params, device, plain_kernels: bool = False):
        from dfq_tpu_torch.engine import Int8FusedNet, lower_int8
        from dfq_tpu_torch.pipeline import QuantConfig, prepare

        self.split: Dict[str, float] = {}
        t = time.perf_counter()
        spec = cfg["program"]
        graph = load(spec["graph"])(**spec.get("graph_kwargs", {}))
        seeded.check_against(graph, params)
        self._lap("graph", t)
        t = time.perf_counter()
        prep = prepare(graph, params, QuantConfig(quantize=True, **cfg["quant"]))
        self._lap("dfq_passes", t)
        t = time.perf_counter()
        model = lower_int8(prep)
        residual = {k: v for k, v in prep.params.items() if k not in model.layers}
        self._lap("lower_int8", t)
        t = time.perf_counter()
        self.net = Int8FusedNet(model, device=device, params_f32=residual,
                                plain_kernels=plain_kernels)
        self._lap("int8_fused_pack", t)
        t = time.perf_counter()
        if torch.device(device).type == "cuda" and not plain_kernels:
            from dfq_tpu_torch.ops import _build

            for src in _build.SOURCES:
                _build.library(src)  # built once into build/cuda/, then loaded
        self._lap("kernel_load", t)
        task = importlib.import_module(f"portbench.tasks.{cfg['task']}")
        self.task = task.Task(self.net, cfg, device)

    def _lap(self, name: str, t0: float) -> None:
        self.split[name] = time.perf_counter() - t0

    def kernel_sites(self, batch: int):
        """``[(node, kernel)]`` of every kernel launch a forward at
        ``batch`` makes (read from the packed lowering)."""
        return [(name, kernel) for name, kernel, _ in self.net.lowering(batch).kernel_sites]

    def launches(self):
        """The program's count of launches per kernel so far."""
        from dfq_tpu_torch.ops import cuda_int8

        return dict(cuda_int8.LAUNCHES)
