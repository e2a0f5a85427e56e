"""Model-level engine-policy autotuner (port of ``dfq_tpu/engine/autotune.py``).

The fused engine lowers a depthwise conv that no kernel takes in two
exact forms, grouped or dense-diagonal (``int8_fused._dense_diag_weights``),
and which one runs faster depends on the whole model, the batch and the
device (on the TPU the same conv shape had opposite winners in two
models). So the candidates are raced on the device at the model level, and
the winner is cached by the model's topology, batch, device and this
engine's schema version.

The race builds one :class:`~dfq_tpu_torch.engine.Int8FusedNet` per
candidate (packing is paid once, outside the timing) and times its
forward: on CUDA between CUDA events around back-to-back forwards, on the
CPU with ``time.perf_counter``; the rounds interleave the candidates and
each candidate's time is the lower median of its rounds, reported with
its spread (the fastest and slowest round).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dfq_tpu_torch.device import resolve_device

__all__ = ["dw_policy_candidates", "autotune_dw_policy", "model_signature", "time_forward"]

# folded into every signature: a change to the engine's lowerings or to the
# candidates' meaning must bump it, so that no cached winner outlives them
SCHEMA_VERSION = "dfq_tpu_torch.int8_fused/policies-2"


def dw_policy_candidates(per_device_batch: int) -> List[Dict[str, Any]]:
    """The depthwise-lowering policies worth racing (the JAX package's
    three): the engine's ``"auto"`` policy, dense-diagonal up to 32
    channels on maps up to 160 high, and grouped everywhere."""
    del per_device_batch  # same candidate set at every batch
    return [
        {"_label": "auto"},
        {"_label": "dense32_h160", "dw_dense_max_ch": 32, "dw_dense_max_h": 160},
        {"_label": "grouped", "dw_dense_max_ch": 0},
    ]


def device_name(device=None) -> str:
    """``torch.cuda.get_device_name`` of a CUDA device, ``"cpu"`` for the CPU."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def model_signature(model, batch: int, extra: str = "", device=None) -> str:
    """Stable cache key of (lowered model topology, batch, device name,
    engine schema version, ``extra``). Topology only: weight values do
    not change which lowering is faster, so retrained weights reuse the
    cached policy."""
    h = hashlib.sha256()
    for node in model.graph:
        h.update(node.name.encode())
        h.update(str(sorted((k, str(v)) for k, v in (node.attrs or {}).items())).encode())
        h.update(node.op.encode())
    h.update(f"|b{batch}|{device_name(device)}|{SCHEMA_VERSION}|{extra}".encode())
    return h.hexdigest()[:16]


def time_forward(fwds: Sequence[Callable[[], Any]], device, reps: int = 5,
                 rounds: int = 3) -> List[List[float]]:
    """Per call of each of ``fwds``, the ms of every round: each round
    runs every function ``reps`` times back to back, in turn, after one
    warm-up call each. CUDA: between CUDA events, synchronised at the end
    of each timing; the CPU: ``time.perf_counter``."""
    cuda = torch.device(device).type == "cuda"
    with torch.no_grad():
        for f in fwds:
            f()
        if cuda:
            torch.cuda.synchronize(device)
        per: List[List[float]] = [[] for _ in fwds]
        for _ in range(rounds):
            for i, f in enumerate(fwds):
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(reps):
                        f()
                    end.record()
                    end.synchronize()
                    per[i].append(start.elapsed_time(end) / reps)
                else:
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        f()
                    per[i].append((time.perf_counter() - t0) * 1e3 / reps)
    return per


def _lower_median(v: List[float]) -> float:
    s = sorted(v)
    return s[(len(s) - 1) // 2]


def _read_cache(path: Path) -> Dict[str, Any]:
    """The cache's entries; a missing, unreadable, corrupt or truncated
    file counts as empty (the caller races again), never raises."""
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def _write_cache(path: Path, cache: Dict[str, Any]) -> None:
    """Write atomically: a temporary file in the same directory, then
    ``os.replace``, so a reader sees the old file or the new one whole,
    and a write that fails leaves the old file as it was."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(cache, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def autotune_dw_policy(
    model,
    params,
    x: torch.Tensor,
    candidates: Optional[Sequence[Dict[str, Any]]] = None,
    cache_path: Optional[str] = None,
    per_device_batch: Optional[int] = None,
    rounds: int = 3,
    executor=None,
    reps: int = 5,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Race the candidate depthwise policies on ``x``'s device; return
    ``(policy_kwargs, report)``.

    ``policy_kwargs`` feeds straight into ``Int8FusedNet(**...)`` or
    :func:`~dfq_tpu_torch.engine.execute_int8_fused` (the ``_label`` key
    is stripped). ``params`` are the f32 params of the layers that were not
    lowered (``params_f32``). ``report`` has the winner's ``label`` and
    ``ms``, and ``rows``: each candidate's lower-median ``ms`` with its
    ``ms_min`` and ``ms_max`` over the rounds; a winner by less than the
    spread is noise, and the caller should read it so.

    With ``cache_path`` set, a JSON cache keyed by :func:`model_signature`
    skips the race on a hit (an entry whose label is not among the
    candidates is ignored); a missing or corrupt file counts as empty, and
    the winner is written atomically. ``cache_path=None`` (the default)
    writes nothing.

    ``executor``: ``(model, params, x, per_device_batch=..., **policy) ->
    outputs`` timed in place of each candidate's net (the JAX package's
    hook; a test forces a winner with it).
    """
    from dfq_tpu_torch.engine.int8_fused import Int8FusedNet

    batch = per_device_batch or x.shape[0]
    device = x.device
    cands = list(candidates or dw_policy_candidates(batch))
    sig = model_signature(model, batch, device=device)
    labels = {c["_label"]: c for c in cands}

    path = Path(cache_path) if cache_path else None
    if path is not None:
        hit = _read_cache(path).get(sig)
        if isinstance(hit, dict) and hit.get("label") in labels:
            pol = {k: v for k, v in labels[hit["label"]].items() if k != "_label"}
            return pol, {"cached": True, "signature": sig, **hit}

    pols = [{k: v for k, v in c.items() if k != "_label"} for c in cands]
    if executor is None:
        nets = [Int8FusedNet(model, device=device, params_f32=params,
                             per_device_batch=per_device_batch, **p) for p in pols]
        fwds = [lambda n=n: n(x) for n in nets]
    else:
        fwds = [lambda p=p: executor(model, params, x, per_device_batch=per_device_batch, **p)
                for p in pols]
    per = time_forward(fwds, device, reps=reps, rounds=rounds)
    rows = []
    for c, p, t in zip(cands, pols, per):
        row = {"label": c["_label"], "ms": _lower_median(t), "ms_min": min(t),
               "ms_max": max(t), "policy": p}
        print(f"# autotune {row['label']}: {row['ms']:.4f} ms a forward "
              f"(rounds {min(t):.4f}-{max(t):.4f})", file=sys.stderr)
        rows.append(row)
    best = int(np.argmin([r["ms"] for r in rows]))
    report = {"cached": False, "signature": sig, "label": rows[best]["label"],
              "ms": rows[best]["ms"], "device": device_name(device), "rows": rows}
    if path is not None:
        cache = _read_cache(path)
        cache[sig] = {"label": report["label"], "ms": report["ms"]}
        _write_cache(path, cache)
    return pols[best], report
