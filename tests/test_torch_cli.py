"""The port's classification entry point (``dfq_tpu_torch.cli.run_cls``) on
the CPU: each engine on the 8 seeded 224x224 smoke images, the artifact it
saves reproducing its network bit for bit, ``--aot-batch`` writing its
payload into the artifact (the card's steps replaced as in
``tests/test_torch_aot.py``) and refusing the CPU, and ``--stream`` on a
synthetic ImageNet folder giving the synchronous loop's accuracy and the
JAX entry point's (``tests/test_data_and_cli.py:231``)."""

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


@pytest.fixture(scope="module")
def imagenet_tree(tmp_path_factory):
    """A copy of ``tests/test_data_and_cli.py``'s ``imagenet_tree``."""
    from PIL import Image

    root = tmp_path_factory.mktemp("imagenet_val")
    rng = np.random.default_rng(0)
    for cls in ("n01440764", "n01443537"):
        d = root / cls
        d.mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (256, 300, 3), np.uint8)).save(
                d / f"img_{i}.jpg")
    return str(root)


def test_run_cls_stream_matches_sync(imagenet_tree, monkeypatch, capsys):
    """``--stream`` (batches kept in flight) counts the synchronous loop's
    correct predictions and images, and reports the JAX entry point's
    accuracy with the same flags on the same folder (ResNet-18, random
    weights from the seed, fused engine: JAX compiles it in less than half
    MobileNetV2's time). The folder's labels are replaced by the port's own
    predictions at even images and another class at odd ones, so that
    exactly half the images count as correct."""
    import sys

    import dfq_tpu.data
    import dfq_tpu_torch.data
    from dfq_tpu.cli import run_cls as j_run_cls

    flags = ["--resnet", "--quantize", "--relu", "--equalize", "--bits_bias", "16",
             "--engine", "fused", "--data-dir", imagenet_tree, "--batch-size", "2",
             "--limit", "6"]
    first = run_cls.main(flags + ["--device", "cpu"])
    (imgs, _), = dfq_tpu_torch.data.imagenet_batches(imagenet_tree, 6)
    with torch.no_grad():
        pred = first["forward"](torch.from_numpy(imgs)).argmax(-1).numpy()
    hit = np.where(np.arange(6) % 2 == 0, pred, (pred + 1) % 1000).astype(np.int32)

    def relabelled(loader):
        def batches(*args, **kwargs):
            seen = 0
            for x, y in loader(*args, **kwargs):
                yield x, hit[seen:seen + len(y)]
                seen += len(y)
        return batches

    monkeypatch.setattr(dfq_tpu_torch.data, "imagenet_batches",
                        relabelled(dfq_tpu_torch.data.imagenet_batches))
    monkeypatch.setattr(dfq_tpu.data, "imagenet_batches", relabelled(dfq_tpu.data.imagenet_batches))
    capsys.readouterr()
    counts = []
    for extra in ([], ["--stream"]):
        out = run_cls.main(flags + ["--device", "cpu"] + extra)
        assert f"Acc: {out['acc']}" in capsys.readouterr().out
        counts.append(out["counts"])
    assert counts[0] == counts[1] == (3, 6)
    monkeypatch.setattr(sys, "argv", ["run_cls"] + flags + ["--stream"])
    j_run_cls.main()
    j_acc = float(capsys.readouterr().out.split("Acc: ")[1].split()[0])
    assert j_acc == 0.5


def test_trainable_refuses_int8_engines():
    with pytest.raises(SystemExit, match="fake-quant regime"):
        run_cls.main(DFQ + ["--trainable", "--engine", "int8"])
