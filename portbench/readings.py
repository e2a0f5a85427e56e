"""What each per-layer metric reads, shared by the reader files of
``layer_metrics/``: a reader is one name bound to one of these. ``t`` is a
run's record: the traced stretch's sums (``stretch``), host-clock spans,
the batcher's counters, and the frozen costs. Each returns None where it
finds nothing to read."""

from __future__ import annotations

from typing import Dict, Optional


def idle_share_pct(t: Dict) -> Optional[float]:
    """Share of the traced stretch in which no operation ran on the
    device."""
    st = t.get("stretch")
    if not st or st["window_s"] <= 0 or st["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - st["busy_s"] / st["window_s"])


def mfu_pct(t: Dict) -> Optional[float]:
    """The whole step's share of the card's published int8 rate: the
    model's int8 operations per image (2 per MAC of every conv and linear
    layer, from shapes) times the images per second of the traced
    stretch."""
    st, pk = t.get("stretch"), t.get("peaks")
    if not st or not pk or not t.get("stretch_images"):
        return None
    rate = t["ops_per_image"] * t["stretch_images"] / st["window_s"]
    return 100.0 * rate / pk["int8_ops"]


def kernels_roofline_pct(t: Dict) -> Optional[float]:
    """The three hand-written kernels' share of their roofline: the sum
    over their call sites of max(operations / int8 peak, bytes / memory
    rate), over their summed device time in the traced stretch. Nothing
    is read when the traced calls per kernel are not the lowering's sites
    times the steps traced."""
    st, pk = t.get("stretch"), t.get("peaks")
    steps = t.get("stretch_steps")
    if not st or not pk or not steps:
        return None
    for kernel, n in t["sites_per_step"].items():
        if st["kernels"][kernel]["calls"] != n * steps:
            return None
    spent = sum(k["s"] for k in st["kernels"].values())
    return 100.0 * t["kernel_bound_s_per_step"] * steps / spent if spent > 0 else None


def glue_ms_per_image(t: Dict) -> Optional[float]:
    """Device time per image of every traced device operation that is not
    one of the three hand-written kernels and not part of an NMS call:
    the glue (exact int8 convs, float epilogues, copies, fallbacks)."""
    st = t.get("stretch")
    if not st or not t.get("stretch_images"):
        return None
    total = sum(op[1] for op in st["device_ops"])
    glue = total - sum(k["s"] for k in st["kernels"].values()) - st["nms_device_s"]
    return 1e3 * glue / t["stretch_images"]


def nms_ms_per_batch(t: Dict) -> Optional[float]:
    """Mean host-clock time of one ``decode_nms_batch`` call, between a
    device synchronisation before it and one after, outside the
    profiler."""
    s = t.get("spans", {}).get("nms")
    return 1e3 * sum(s) / len(s) if s else None


def dispatch_ms(t: Dict) -> Optional[float]:
    """Mean host-clock time of one dispatch of the batcher's
    ``forward_fn``: the host-to-device copy, the forward (and NMS), until
    the result rows are on the host."""
    s = t.get("spans", {}).get("dispatch")
    return 1e3 * sum(s) / len(s) if s else None


def batch_fill_pct(t: Dict) -> Optional[float]:
    """Share of the dispatched rows that were requests, not padding
    (``MicroBatcher.stats()``: items / (items + padded), over the
    window)."""
    b = t.get("batcher")
    if not b or not b["items"]:
        return None
    return 100.0 * b["items"] / (b["items"] + b["padded"])


def images_per_s(r: Dict) -> Optional[float]:
    """End-to-end: images completed in the window over the window's whole
    time, from the first step's launch to the last step's end on the
    device."""
    return r["images"] / r["window_s"] if r.get("steps") else None
