"""The port's classification entry point (``dfq_tpu_torch.cli.run_cls``) on
the CPU: each engine on the 8 seeded 224x224 smoke images, the artifact it
saves reproducing its network bit for bit, ``--aot-batch`` writing its
payload into the artifact (the card's steps replaced as in
``tests/test_torch_aot.py``) and refusing the CPU, and the flags whose
modules are not ported yet refused with the ROADMAP item that ports them
(``--stream`` only where it would stream, with ``--data-dir``)."""

import numpy as np
import pytest
import torch

from dfq_tpu_torch.cli import run_cls
from dfq_tpu_torch.engine import Int8FusedNet, Int8Net
from dfq_tpu_torch.io import load_artifact

torch.set_num_threads(1)
DFQ = ["--quantize", "--relu", "--equalize", "--bits_bias", "16", "--device", "cpu"]


def _smoke():
    x = np.random.default_rng(0).normal(0, 1, (8, 224, 224, 3)).astype(np.float32)
    return torch.from_numpy(x)


def test_sim_engine(capsys):
    out = run_cls.main(DFQ + ["--correction", "--engine", "sim"])
    assert out["logits"].shape == (8, 1000) and np.isfinite(out["logits"]).all()
    assert "smoke eval ok: logits shape (8, 1000), finite=True" in capsys.readouterr().out


@pytest.mark.parametrize("engine", ["int8", "fused"])
def test_int8_engines_and_artifact(engine, tmp_path, capsys):
    art = str(tmp_path / "art")
    out = run_cls.main(DFQ + ["--resnet", "--engine", engine, "--save-artifact", art])
    printed = capsys.readouterr().out
    assert f"artifact saved to {art}" in printed
    assert "smoke eval ok: logits shape (8, 1000), finite=True" in printed
    model, residual = load_artifact(art)
    net = (Int8FusedNet(model, device="cpu", params_f32=residual) if engine == "fused"
           else Int8Net(model, residual, device="cpu"))
    with torch.no_grad():
        again = net(_smoke()).numpy()
    assert np.array_equal(again, out["logits"])
    assert set(residual) == set(out["params"]) and model.layers.keys() == out["model"].layers.keys()


def test_aot_batch_writes_payload(tmp_path, monkeypatch, capsys):
    import json
    import os

    from dfq_tpu_torch.io import aot
    from dfq_tpu_torch.ops import _build

    monkeypatch.setattr(aot, "current_meta", lambda device=None: {
        "device_name": "card", "capability": "9.0", "torch_version": torch.__version__,
        "torch_cuda": "12.8", "sources_sha256": _build.sources_digest()})
    monkeypatch.setattr(aot, "nvcc_release", lambda: "12.8")
    libs = {s: tmp_path / _build._library_path(s).name for s in _build.SOURCES}
    for p in libs.values():
        p.write_bytes(b"lib")
    monkeypatch.setattr(_build, "build", lambda sources=_build.SOURCES: dict(libs))
    monkeypatch.setattr(_build, "load_prebuilt", lambda paths: None)
    art = str(tmp_path / "art")
    out = run_cls.main(DFQ + ["--engine", "fused", "--save-artifact", art, "--aot-batch", "2"])
    assert "AOT kernels (batch 2) saved into the artifact" in capsys.readouterr().out
    meta = json.loads(open(os.path.join(art, "aot", "meta.json")).read())
    assert meta["batch"] == 2 and meta["image_size"] == 224
    assert sorted(os.listdir(os.path.join(art, "aot"))) == sorted(
        [p.name for p in libs.values()] + ["meta.json"])
    fwd = aot.load_aot_forward(art, device="cpu")
    with torch.no_grad():
        assert np.array_equal(fwd(_smoke()).numpy(), out["logits"])


@pytest.mark.parametrize("flags,match", [
    (["--engine", "fused", "--save-artifact", "art"], "--aot-batch: .*plain versions"),
    (["--engine", "int8", "--save-artifact", "art"], "--aot-batch ships the fused engine"),
    (["--engine", "fused"], "--aot-batch ships the fused engine")])
def test_aot_batch_refusals_name_the_flag(flags, match):
    with pytest.raises(SystemExit, match=match):
        run_cls.main(DFQ + flags + ["--aot-batch", "8"])


@pytest.mark.parametrize("flag", [["--stream", "--data-dir", "imagenet/val"]])
def test_unported_flags_exit_nonzero(flag):
    with pytest.raises(SystemExit) as e:
        run_cls.main(DFQ + flag)
    assert e.value.code not in (0, None)
    assert flag[0] in str(e.value.code) and "ROADMAP.md" in str(e.value.code)


def test_trainable_refuses_int8_engines():
    with pytest.raises(SystemExit, match="fake-quant regime"):
        run_cls.main(DFQ + ["--trainable", "--engine", "int8"])
