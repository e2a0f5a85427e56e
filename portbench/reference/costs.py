"""Operations and bytes of a model and of the kernels' call sites, from shapes
alone, and the published peaks they are held against.

Counts, frozen with the benchmark (the arithmetic of
``dfq_tpu_torch/utils/profiling.py:layer_costs``, without its TPU tiling
model): 2 operations per multiply-accumulate of every conv and linear
layer. One departure: a global pool's output is 1x1 here, where
``layer_costs`` keeps its input's side and so counts the conv after it
(DeepLab's ``aspp.global_avg_pool.1``) at the full map. Bytes count each
tensor a call needs once, at the width the int8 engine stores it in
(activations and weights 1 byte, per-channel scale and bias 4 bytes
each, a float32 output 4 bytes).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .dfq.ir import QUANTIZED_INPUT_OPS, Graph

# NVIDIA's data sheets, dense rates without sparsity, at the full power
# limit; matched as substrings of torch.cuda.get_device_name, in order
PEAKS: List[Tuple[str, Dict[str, float]]] = [
    ("H100 PCIe", {"int8_ops": 1513e12, "hbm_bytes": 2.0e12}),
    ("H100", {"int8_ops": 1979e12, "hbm_bytes": 3.35e12}),
]

# ops through which the int8 engine carries an int8 tensor on its grid
_PASS = {"relu", "relu6", "bn", "identity", "dropout", "maxpool", "pad"}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    for key, p in PEAKS:
        if key in device_name:
            return p
    return None


def _out_hw(h: int, node) -> int:
    a = node.attrs
    kh = a["kernel"][0]
    eff = a["dilation"][0] * (kh - 1) + 1
    return (h + 2 * a["padding"][0] - eff) // a["stride"][0] + 1


def shapes(graph: Graph, size: int) -> Dict[str, int]:
    """The spatial side of every node's output map, for a square input:
    convs and max pools (floor mode) by their window, stride and padding,
    pads by their top and bottom, resizes to their ``size`` (or the side
    times ``scale``), global pools and means to 1; other ops keep their
    input's side."""
    hw: Dict[str, int] = {}
    for node in graph:
        a = node.attrs
        h = hw.get(node.inputs[0], 1) if node.inputs else size
        if node.op == "conv":
            h = _out_hw(h, node)
        elif node.op == "maxpool":
            h = (h + 2 * a["padding"][0] - a["window"][0]) // a["stride"][0] + 1
        elif node.op == "pad":
            h += a["pads"][0] + a["pads"][1]
        elif node.op == "interpolate":
            h = a["size"][0] if a.get("size") else int(h * a["scale"])
        elif node.op in ("global_pool", "global_mean"):
            h = 1
        hw[node.name] = h
    return hw


def layer_macs(graph: Graph, size: int) -> Dict[str, int]:
    """Multiply-accumulates per image of every conv and linear layer."""
    hw = shapes(graph, size)
    macs: Dict[str, int] = {}
    for node in graph:
        a = node.attrs
        if node.op == "conv":
            kh, kw = a["kernel"]
            h = hw[node.name]
            macs[node.name] = h * h * a["out_ch"] * (a["in_ch"] // a["groups"]) * kh * kw
        elif node.op == "linear":
            macs[node.name] = a["out_f"] * a["in_f"]
    return macs


def model_ops_per_image(graph: Graph, size: int) -> int:
    return 2 * sum(layer_macs(graph, size).values())


def _consumers(graph: Graph) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {n.name: [] for n in graph}
    for node in graph:
        for i in node.inputs:
            out[i].append(node.name)
    return out


def _int8_output(graph: Graph, cons, name: str) -> bool:
    """Whether the engine stores ``name``'s output as int8: some consumer,
    reached through pass-through ops, quantizes its input."""
    stack = list(cons[name])
    while stack:
        node = graph[stack.pop()]
        if node.op in _PASS:
            stack.extend(cons[node.name])
        elif node.op in QUANTIZED_INPUT_OPS:
            return True
    return False


def _next(graph: Graph, cons, name: str) -> str:
    """The single consumer of ``name`` past pass-through ops."""
    nxt = cons[name]
    while len(nxt) == 1 and graph[nxt[0]].op in _PASS:
        nxt = cons[nxt[0]]
    if len(nxt) != 1:
        raise ValueError(f"{name}: no single consumer ({nxt})")
    return nxt[0]


def block_layers(graph: Graph, expand: str) -> Tuple[str, str, str, Optional[str]]:
    """An inverted-residual block fused into one kernel call, named by its
    expand conv: ``(expand, depthwise, project, add or None)``."""
    cons = _consumers(graph)
    dw = _next(graph, cons, expand)
    proj = _next(graph, cons, dw)
    try:
        last = _next(graph, cons, proj)
    except ValueError:
        last = None
    add = last if last is not None and graph[last].op == "add" else None
    if graph[dw].op != "conv" or graph[proj].op != "conv":
        raise ValueError(f"{expand}: not an expand -> depthwise -> project chain")
    return expand, dw, proj, add


def site_cost(graph: Graph, size: int, batch: int, node_name: str, kernel: str) -> Tuple[float, float]:
    """``(operations, bytes)`` of one kernel call at ``batch``."""
    hw = shapes(graph, size)
    macs = layer_macs(graph, size)
    cons = _consumers(graph)

    def act(name_in: str, ch: int) -> int:
        h = hw[name_in]
        return batch * h * h * ch

    node = graph[node_name]
    if kernel == "fused_block_int8":
        e, d, p, add = block_layers(graph, node_name)
        ne, np_ = graph[e], graph[p]
        c_in, ch_e, c_out = ne.attrs["in_ch"], ne.attrs["out_ch"], np_.attrs["out_ch"]
        ops = 2 * batch * (macs[e] + macs[d] + macs[p])
        last = add or p
        out_w = 1 if _int8_output(graph, cons, last) else 4
        weights = ch_e * c_in + 9 * ch_e + c_out * ch_e + 8 * (2 * ch_e + c_out)
        return ops, act(ne.inputs[0], c_in) + act(p, c_out) * out_w + weights
    if node.op == "linear":
        m, k, n = batch, node.attrs["in_f"], node.attrs["out_f"]
        x_bytes, out_el = m * k, m * n
    else:
        a = node.attrs
        k = a["in_ch"] // a["groups"] * a["kernel"][0] * a["kernel"][1]
        n = a["out_ch"]
        x_bytes, out_el = act(node.inputs[0], a["in_ch"]), act(node_name, n)
    out_w = 1 if _int8_output(graph, cons, node_name) else 4
    ops = 2 * batch * macs[node_name]
    return ops, x_bytes + n * k + 8 * n + out_el * out_w


def site_bound_s(cost: Tuple[float, float], pk: Dict[str, float]) -> float:
    """The least time a call can take: the larger of its operations over
    the int8 peak and its bytes over the memory rate."""
    ops, nbytes = cost
    return max(ops / pk["int8_ops"], nbytes / pk["hbm_bytes"])
