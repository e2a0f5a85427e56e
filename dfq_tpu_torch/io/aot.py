"""Prebuilt kernels inside the deployment artifact (the port's counterpart
of ``dfq_tpu/io/aot.py``): a cold start with no compiler in the loop.

The JAX artifact can carry the fused forward's compiled XLA executable.
The port has no executable to serialize: the fused engine
(:class:`~dfq_tpu_torch.engine.int8_fused.Int8FusedNet`) is built from the
artifact in Python, and its only compile step is ``nvcc``, which builds
the kernel libraries of ``dfq_tpu_torch/csrc`` at first use
(:mod:`dfq_tpu_torch.ops._build`). So ``<artifact>/aot/`` holds:

- those libraries (``<source stem>-<hash>.so``), as the exporting
  process built and ran them;
- ``meta.json``: the card's name and compute capability,
  ``torch.__version__``, ``torch.version.cuda``, the ``nvcc`` release that
  built the libraries, the sha256 of the kernel sources and flags
  (:func:`~dfq_tpu_torch.ops._build.sources_digest`), the library of each
  source, and the ``batch`` and ``image_size`` the export ran.

:func:`load_aot_forward` checks the card, its capability, the torch and
CUDA versions and the source digest against the loading process
(``nvcc_release``, ``batch`` and ``image_size`` are a record: the loading
process has no compiler to ask, and the kernels take any batch), loads the
libraries in place of a build, and returns the fused forward. Nothing is
pickled; ``meta.json`` is plain JSON.

Trust note: a shipped ``.so`` is native code that runs in the loading
process. Load the AOT payload only from artifacts you produced or trust;
without it the artifact is fully usable and the kernels build as usual.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional

AOT_DIR = "aot"
# the fields load_aot_forward holds against the loading process
CHECKED = ("device_name", "capability", "torch_version", "torch_cuda", "sources_sha256")


def current_meta(device=None) -> dict:
    """The checked fields for ``device`` (default the current CUDA device).
    Raises ``ValueError`` for a device that is not CUDA: the CPU runs the
    kernels' plain versions and has no library to ship or load."""
    import torch

    from dfq_tpu_torch.ops import _build

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise ValueError(f"the AOT payload holds CUDA kernel libraries; device {dev} runs "
                         "the kernels' plain versions and has none")
    major, minor = torch.cuda.get_device_capability(dev)
    return {"device_name": torch.cuda.get_device_name(dev), "capability": f"{major}.{minor}",
            "torch_version": torch.__version__, "torch_cuda": torch.version.cuda,
            "sources_sha256": _build.sources_digest()}


def nvcc_release() -> str:
    """The release ``nvcc --version`` reports, e.g. ``12.8``."""
    from dfq_tpu_torch.ops import _build

    out = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                         check=True).stdout
    m = re.search(r"release (\d+\.\d+)", out)
    if not m:
        raise RuntimeError(f"no release in nvcc --version: {out!r}")
    return m.group(1)


def save_aot_forward(path: str, forward, batch: int, image_size: int) -> None:
    """Run ``forward`` (an ``Int8FusedNet`` on the card) once on a zero
    batch of ``batch`` x ``image_size``\\ ² images, so every kernel it
    launches is built and run, then copy the kernel libraries into
    ``<path>/aot/`` beside ``meta.json``."""
    import torch

    from dfq_tpu_torch.ops import _build

    meta = current_meta(forward.device)
    with torch.no_grad():
        forward(torch.zeros(batch, image_size, image_size, 3, device=forward.device))
    if forward.device.type == "cuda":
        torch.cuda.synchronize(forward.device)
    d = os.path.join(path, AOT_DIR)
    os.makedirs(d, exist_ok=True)
    libraries = {}
    for source, lib in _build.build().items():
        shutil.copyfile(lib, os.path.join(d, Path(lib).name))
        libraries[source] = Path(lib).name
    meta.update(nvcc_release=nvcc_release(), libraries=libraries, batch=batch,
                image_size=image_size)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def load_aot_forward(path: str, device=None) -> Optional[object]:
    """The artifact's fused forward on ``device`` (default the current CUDA
    device) with the shipped kernel libraries loaded in place of an
    ``nvcc`` build, its ``aot_meta`` the payload's ``meta.json``; ``None``
    when the artifact carries no AOT payload. Raises ``ValueError`` when
    the payload was made for another card, torch, CUDA or kernel source,
    or a library is missing."""
    d = os.path.join(path, AOT_DIR)
    if not os.path.isdir(d):
        return None
    from dfq_tpu_torch.engine.int8_fused import Int8FusedNet
    from dfq_tpu_torch.io.artifact import load_artifact
    from dfq_tpu_torch.ops import _build

    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    current = current_meta(device)
    for k in CHECKED:
        if meta.get(k) != current[k]:
            raise ValueError(
                f"AOT kernels were built for {k}={meta.get(k)!r} but this process has "
                f"{current[k]!r}; re-export on matching hardware or load the artifact "
                "without the AOT payload")
    libraries = meta.get("libraries") or {}
    if sorted(libraries) != sorted(_build.SOURCES):
        raise ValueError(f"AOT payload lists libraries for {sorted(libraries)}, the kernels "
                         f"are {sorted(_build.SOURCES)}; re-export on matching hardware")
    paths = {s: Path(d) / name for s, name in libraries.items()}
    missing = [str(p) for p in paths.values() if not p.is_file()]
    if missing:
        raise ValueError(f"AOT payload is missing {missing}; re-export on matching hardware "
                         "or load the artifact without the AOT payload")
    _build.load_prebuilt(paths)
    model, residual = load_artifact(path)
    net = Int8FusedNet(model, device=device, params_f32=residual)
    net.aot_meta = meta
    return net
