"""``dfq_tpu_torch.io.aot`` on the CPU: the file logic of the AOT payload
(``<artifact>/aot/``: the kernel libraries and ``meta.json``).

The payload holds CUDA libraries, so making and loading a real one needs
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 16). Here
the CUDA-only steps are replaced: ``current_meta`` by a fixed card,
``nvcc_release`` by a fixed release, ``_build.build`` by stand-in library
files and ``_build.load_prebuilt`` by a recorder. What stays real: the
forward run at the export batch, the files written, the checks of every
meta field, the source digest and the library files, and the fused
forward built from the artifact.

- an artifact without ``aot/`` gives ``None``;
- a payload made here loads back with its meta, and its forward equals
  the exporting net's;
- each checked field that differs raises the documented ``ValueError``
  ("re-export on matching hardware"), as do a source digest of other
  kernels, a library list that is not the kernels', and a missing file;
- the real ``current_meta`` refuses the CPU.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from dfq_tpu_torch.engine import Int8FusedNet
from dfq_tpu_torch.io import aot, load_artifact
from dfq_tpu_torch.ops import _build

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "golden")
CARD = {"device_name": "NVIDIA H100 80GB HBM3", "capability": "9.0",
        "torch_version": torch.__version__, "torch_cuda": "12.8"}


@pytest.fixture
def card(monkeypatch, tmp_path):
    """The CUDA-only steps replaced; returns the libraries handed to
    ``load_prebuilt``."""
    current = dict(CARD, sources_sha256=_build.sources_digest())
    monkeypatch.setattr(aot, "current_meta", lambda device=None: dict(current))
    monkeypatch.setattr(aot, "nvcc_release", lambda: "12.8")
    libs = {}
    for s in _build.SOURCES:
        p = _build._library_path(s)
        fake = tmp_path / "built" / p.name
        fake.parent.mkdir(exist_ok=True)
        fake.write_bytes(b"\x7fELF " + s.encode())
        libs[s] = fake
    monkeypatch.setattr(_build, "build", lambda sources=_build.SOURCES: dict(libs))
    loaded = {}
    monkeypatch.setattr(_build, "load_prebuilt", lambda paths: loaded.update(paths))
    return loaded


@pytest.fixture
def artifact(tmp_path):
    path = tmp_path / "art"
    shutil.copytree(os.path.join(GOLDEN, "artifact"), path)
    return str(path)


@pytest.fixture
def payload(card, artifact):
    model, residual = load_artifact(artifact)
    net = Int8FusedNet(model, device="cpu", params_f32=residual)
    aot.save_aot_forward(artifact, net, 3, 16)
    return artifact, net


def _edit_meta(path, **fields):
    f = os.path.join(path, aot.AOT_DIR, "meta.json")
    meta = json.loads(open(f).read())
    meta.update(fields)
    with open(f, "w") as out:
        json.dump(meta, out)


def test_absent_payload_gives_none(artifact):
    assert aot.load_aot_forward(artifact) is None
    assert aot.load_aot_forward(artifact, device="cpu") is None


def test_payload_files_and_meta(payload):
    path, _ = payload
    d = os.path.join(path, aot.AOT_DIR)
    meta = json.loads(open(os.path.join(d, "meta.json")).read())
    names = {s: _build._library_path(s).name for s in _build.SOURCES}
    assert meta["libraries"] == names
    assert sorted(os.listdir(d)) == sorted(list(names.values()) + ["meta.json"])
    assert meta["batch"] == 3 and meta["image_size"] == 16 and meta["nvcc_release"] == "12.8"
    assert {k: meta[k] for k in aot.CHECKED} == dict(
        CARD, sources_sha256=_build.sources_digest())


def test_matching_payload_loads_without_a_build(payload, card):
    path, net = payload
    fwd = aot.load_aot_forward(path, device="cpu")
    assert sorted(card) == sorted(_build.SOURCES)
    assert all(os.path.dirname(p) == os.path.join(path, aot.AOT_DIR) for p in card.values())
    assert fwd.aot_meta["batch"] == 3
    x = torch.from_numpy(np.load(os.path.join(GOLDEN, "input.npy")))
    with torch.no_grad():
        assert torch.equal(fwd(x), net(x))


@pytest.mark.parametrize("field", aot.CHECKED)
def test_each_checked_field_that_differs_raises(payload, card, field):
    path, _ = payload
    _edit_meta(path, **{field: "something else"})
    with pytest.raises(ValueError, match="re-export on matching hardware"):
        aot.load_aot_forward(path, device="cpu")
    assert not card


def test_recorded_fields_do_not_block_loading(payload):
    path, _ = payload
    _edit_meta(path, nvcc_release="12.4", batch=128, image_size=224)
    assert aot.load_aot_forward(path, device="cpu").aot_meta["batch"] == 128


def test_sources_of_this_tree_differ(payload, monkeypatch):
    """Kernels built from other sources than the wrappers expect."""
    path, _ = payload
    monkeypatch.setattr(_build, "sources_digest", lambda: "0" * 64)
    monkeypatch.setattr(aot, "current_meta", lambda device=None: dict(
        CARD, sources_sha256=_build.sources_digest()))
    with pytest.raises(ValueError, match="sources_sha256"):
        aot.load_aot_forward(path, device="cpu")


def test_missing_library_raises(payload, card):
    path, _ = payload
    os.remove(os.path.join(path, aot.AOT_DIR, _build._library_path(_build.SOURCES[0]).name))
    with pytest.raises(ValueError, match="missing"):
        aot.load_aot_forward(path, device="cpu")
    assert not card


def test_library_list_of_other_kernels_raises(payload, card):
    path, _ = payload
    _edit_meta(path, libraries={"matmul_int8_requant.cu": "x.so"})
    with pytest.raises(ValueError, match="re-export on matching hardware"):
        aot.load_aot_forward(path, device="cpu")
    assert not card


def test_digest_follows_the_sources(tmp_path, monkeypatch):
    d0 = _build.sources_digest()
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.sources_digest() == d0
    (csrc / _build.SOURCES[1]).write_text((csrc / _build.SOURCES[1]).read_text() + "\n")
    assert _build.sources_digest() != d0


def test_current_meta_refuses_the_cpu():
    with pytest.raises(ValueError, match="plain versions"):
        aot.current_meta("cpu")
