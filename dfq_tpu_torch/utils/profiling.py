"""Profiling and per-layer roofline accounting (port of
``dfq_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` context that writes a Chrome /
  TensorBoard trace of the CPU and (where there is one) the card;
- :func:`layer_costs`: static per-layer operations and bytes of a graph at
  a batch and input size, field for field the JAX package's;
- :func:`roofline_report`: the model's time lower bounds against a card's
  peaks, per layer and summed, with the JAX package's arithmetic;
- :data:`PEAKS`: NVIDIA's published peaks by card name, and
  :func:`card_peaks` / :func:`device_peaks` to look one up.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Tuple

import torch

from dfq_tpu_torch.graph.ir import Graph

# Published peaks by card name (dense rates, no sparsity), from NVIDIA's
# data sheets: "NVIDIA H100 Tensor Core GPU" (SXM and PCIe columns) and
# "NVIDIA H200 Tensor Core GPU" (SXM). Keys are matched as substrings of
# ``torch.cuda.get_device_name``, in this order (an H100 PCIe's name also
# holds "H100"). They assume the card's full power limit (700 W for the
# SXM parts); a card set below it runs slower under load.
PEAKS: Dict[str, Dict[str, float]] = {
    "H200": {"int8_ops": 1979e12, "bf16_flops": 989e12, "f32_flops": 67e12,
             "hbm_bytes": 4.8e12},
    "H100 PCIe": {"int8_ops": 1513e12, "bf16_flops": 756e12, "f32_flops": 51e12,
                  "hbm_bytes": 2.0e12},
    "H100": {"int8_ops": 1979e12, "bf16_flops": 989e12, "f32_flops": 67e12,
             "hbm_bytes": 3.35e12},  # SXM, HBM3
}


def card_peaks(name: str) -> Tuple[str, Dict[str, float]]:
    """``(table key, peaks)`` of the card named ``name``; raises for a card
    the table does not have."""
    for key, peaks in PEAKS.items():
        if key in name:
            return key, dict(peaks)
    raise RuntimeError(f"no peak table for card {name!r}")


def device_peaks(device=None) -> Dict[str, float]:
    """The peaks of a CUDA ``device`` (default: the current one); raises
    without CUDA: a roofline of the CPU is not this table's."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass peaks= explicitly")
    return card_peaks(torch.cuda.get_device_name(device))[1]


def calibrated_rates(peaks: Dict[str, float]) -> Dict[str, float]:
    """The default calibrated rates: the peaks themselves, since no rate
    of the card has been measured into this library (``dw_eff_bytes``:
    the memory rate of depthwise layers; ``mxu_int8_eff``: the int8
    matrix rate, the tensor cores here; the JAX package's names)."""
    return {"dw_eff_bytes": peaks["hbm_bytes"], "mxu_int8_eff": peaks["int8_ops"]}


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace("/tmp/prof"): fn()`` records the CPU and, with CUDA,
    the card, and writes a Chrome / TensorBoard trace (``*.pt.trace.json``)
    into ``logdir``. Yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _padded_act_elems(batch: int, h: int, w: int, c: int, dtype_bytes: int,
                      sublane_pad: bool = False) -> int:
    """Element count of a (B,H,W,C) activation under the TPU's 128-lane
    tiling model (the minor, channel dim padded to 128; with
    ``sublane_pad`` the second-minor to 8/16/32 rows for 4/2/1-byte
    dtypes). Kept so ``bytes_padded`` equals the JAX package's; it is the
    TPU's layout, not a bound of this card."""
    sub = {1: 32, 2: 16, 4: 8}[dtype_bytes] if sublane_pad else 1
    return batch * h * _ceil_to(w, sub) * _ceil_to(c, 128)


def _padded_weight_elems(kh: int, kw: int, cin_g: int, cout: int, dtype_bytes: int) -> int:
    # lane-only model, matching _padded_act_elems
    return kh * kw * cin_g * _ceil_to(cout, 128)


def _spatial_out(h: int, node) -> int:
    kh, _ = node.attrs["kernel"]
    sh, _ = node.attrs["stride"]
    ph, _ = node.attrs["padding"]
    dh, _ = node.attrs["dilation"]
    eff = dh * (kh - 1) + 1
    return (h + 2 * ph - eff) // sh + 1


def layer_costs(graph: Graph, batch: int, input_size: int, act_bytes: int = 1,
                weight_bytes: int = 1) -> List[Dict]:
    """Per conv and linear layer: ``name``, ``kind`` (``dw``, ``pw``,
    ``conv``, ``linear``), ``flops`` (2 per MAC), ``bytes`` (input and
    output once at ``act_bytes``, weights once at ``weight_bytes``) and
    ``bytes_padded`` (the same under the TPU's 128-lane tiling model of
    :func:`_padded_act_elems`, which is not a bound on the card), at a
    square ``input_size``. ``act_bytes=1`` models the int8 fused engine, 4
    the f32 path."""
    sizes: Dict[str, int] = {}
    out: List[Dict] = []
    for node in graph:
        if node.op == "input":
            sizes[node.name] = input_size
            continue
        h_in = sizes.get(node.inputs[0], input_size) if node.inputs else input_size
        h = h_in
        if node.op == "conv":
            h = _spatial_out(h_in, node)
            a = node.attrs
            kh, kw = a["kernel"]
            macs = batch * h * h * a["out_ch"] * (a["in_ch"] // a["groups"]) * kh * kw
            w_elems = a["out_ch"] * (a["in_ch"] // a["groups"]) * kh * kw
            bytes_ = (batch * h_in * h_in * a["in_ch"] * act_bytes
                      + batch * h * h * a["out_ch"] * act_bytes
                      + w_elems * weight_bytes)
            bytes_padded = (
                _padded_act_elems(batch, h_in, h_in, a["in_ch"], act_bytes) * act_bytes
                + _padded_act_elems(batch, h, h, a["out_ch"], act_bytes) * act_bytes
                + _padded_weight_elems(kh, kw, a["in_ch"] // a["groups"], a["out_ch"],
                                       weight_bytes) * weight_bytes
            )
            out.append({
                "name": node.name,
                "kind": "dw" if a["groups"] > 1 else ("pw" if (kh, kw) == (1, 1) else "conv"),
                "flops": 2 * macs,
                "bytes": bytes_,
                "bytes_padded": bytes_padded,
            })
        elif node.op == "linear":
            a = node.attrs
            macs = batch * a["in_f"] * a["out_f"]
            out.append({
                "name": node.name,
                "kind": "linear",
                "flops": 2 * macs,
                "bytes": batch * (a["in_f"] + a["out_f"]) * act_bytes
                + a["in_f"] * a["out_f"] * weight_bytes,
                "bytes_padded": (_padded_act_elems(1, 1, batch, a["in_f"], act_bytes)
                                 + _padded_act_elems(1, 1, batch, a["out_f"], act_bytes))
                * act_bytes
                + _padded_weight_elems(1, 1, a["in_f"], a["out_f"], weight_bytes) * weight_bytes,
            })
        elif node.op == "pad":
            h = h_in + node.attrs["pads"][0] + node.attrs["pads"][1]
        elif node.op in ("maxpool", "avgpool"):
            wh, _ = node.attrs["window"]
            sh, _ = node.attrs["stride"]
            ph, _ = node.attrs["padding"]
            h = (h_in + 2 * ph - wh) // sh + 1
        elif node.op == "interpolate" and node.attrs.get("size"):
            h = node.attrs["size"][0]
        sizes[node.name] = h
    return out


def roofline_report(
    graph: Graph,
    batch: int,
    input_size: int = 224,
    peaks: Optional[Dict[str, float]] = None,
    act_bytes: int = 1,
    measured_time_s: Optional[float] = None,
    measured_rates: Optional[Dict[str, float]] = None,
) -> Dict:
    """Per-layer speed of light: ``sum_l max(t_compute_l, t_memory_l)``,
    the sequential bound of a model whose layers do not overlap
    (``t_sol_s``), beside the aggregate ``max(sum flops, sum bytes)``
    (``t_sol_aggregate_s``, optimistic for a mixed model), the per-layer
    sum at the peaks without calibration (``t_sol_peak_s``) and with the
    tile-padded bytes of :func:`layer_costs` (``t_sol_achievable_s``, the
    TPU's layout model). ``peaks`` default to the current card's
    (:func:`device_peaks`); ``measured_rates`` override
    :func:`calibrated_rates` (``dw_eff_bytes`` for depthwise layers' memory
    terms, ``mxu_int8_eff`` for the others' compute terms). With
    ``measured_time_s``, ``sol_fraction`` is ``t_sol_s`` over it. The
    arithmetic is the JAX package's."""
    peaks = peaks or device_peaks()
    rates = calibrated_rates(peaks)
    if measured_rates:
        rates.update(measured_rates)
    costs = layer_costs(graph, batch, input_size, act_bytes=act_bytes)
    total_flops = sum(c["flops"] for c in costs)
    total_bytes = sum(c["bytes"] for c in costs)

    t_layer_sum = 0.0
    t_layer_sum_peak = 0.0
    t_layer_sum_ach = 0.0
    t_in_memory_bound = 0.0
    for c in costs:
        t_c = c["flops"] / peaks["int8_ops"]
        t_m = c["bytes"] / peaks["hbm_bytes"]
        t_peak = max(t_c, t_m)
        if c["kind"] == "dw":
            # memory term at the (possibly sub-peak) calibrated dw rate
            t_c_used = c["flops"] / peaks["int8_ops"]
            t_m_used = c["bytes"] / rates["dw_eff_bytes"]
            dw_capped = rates["dw_eff_bytes"] < peaks["hbm_bytes"]
            label_mem = "dw-vpu" if dw_capped and t_m_used > t_m else "memory"
        else:
            t_c_used = c["flops"] / rates["mxu_int8_eff"]
            t_m_used = t_m
            label_mem = "memory"
        t = max(t_c_used, t_m_used)
        t_m_ach = c.get("bytes_padded", c["bytes"]) / (
            rates["dw_eff_bytes"] if c["kind"] == "dw" else peaks["hbm_bytes"])
        t_ach = max(t_c_used, t_m_ach)
        c["t_sol_s"] = t
        c["t_peak_s"] = t_peak
        c["t_achievable_s"] = t_ach
        c["bound"] = label_mem if t_m_used >= t_c_used else "compute"
        t_layer_sum += t
        t_layer_sum_peak += t_peak
        t_layer_sum_ach += t_ach
        if t_m_used >= t_c_used:
            t_in_memory_bound += t

    t_compute = total_flops / peaks["int8_ops"]
    t_memory = total_bytes / peaks["hbm_bytes"]
    t_aggregate = max(t_compute, t_memory)
    report = {
        "total_flops": total_flops,
        "total_bytes": total_bytes,
        "total_bytes_padded": sum(c.get("bytes_padded", c["bytes"]) for c in costs),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_sol_s": t_layer_sum,
        "sol_images_per_s": batch / t_layer_sum,
        "t_sol_achievable_s": t_layer_sum_ach,
        "sol_achievable_images_per_s": batch / t_layer_sum_ach,
        "t_sol_peak_s": t_layer_sum_peak,
        "sol_peak_images_per_s": batch / t_layer_sum_peak,
        "t_sol_aggregate_s": t_aggregate,
        "sol_aggregate_images_per_s": batch / t_aggregate,
        "bound": "memory" if t_in_memory_bound >= t_layer_sum / 2 else "compute",
        "memory_bound_time_fraction": t_in_memory_bound / t_layer_sum,
        "layers": costs,
    }
    if measured_time_s is not None:
        report["measured_s"] = measured_time_s
        report["sol_fraction"] = t_layer_sum / measured_time_s
        report["achievable_fraction"] = t_layer_sum_ach / measured_time_s
    return report
