"""The rest of the port's calibration family against the JAX package on the
CPU, on ``tests/test_inventory_extras.py``'s ``_tiny_conv_bn_conv``:
``recon_data`` (the reconstruction-variant synthesis), ``estimate_stats``
(the EMA of real-image ranges) and ``learn_scales`` (learned
equalization scales), each with the JAX suite's contract and, for
``estimate_stats`` and ``learn_scales``, against the JAX function's own
result on the same inputs."""

import numpy as np
import pytest
import torch

from dfq_tpu.calib import estimate_stats as j_estimate_stats
from dfq_tpu.calib.recon import ReconConfig as JReconConfig
from dfq_tpu.calib.recon import recon_batch_fn as j_recon_batch_fn
from dfq_tpu.graph.ir import GraphBuilder
from dfq_tpu.models import init_params
from dfq_tpu.passes import create_relations as j_create_relations
from dfq_tpu.passes import fold_batchnorm as j_fold_batchnorm
from dfq_tpu.passes import learn_scales as j_learn_scales
from dfq_tpu_torch.calib import estimate_stats
from dfq_tpu_torch.calib.distill import DistillConfig, init_random_batch
from dfq_tpu_torch.calib.recon import ReconConfig, recon_batch_fn, recon_data
from dfq_tpu_torch.graph import execute
from dfq_tpu_torch.interop import graph_from_jax, params_from_jax
from dfq_tpu_torch.passes import create_relations, fold_batchnorm, learn_scales

torch.set_num_threads(1)


def _tiny_conv_bn_conv(seed=0):
    """``tests/test_inventory_extras.py``'s ``_tiny_conv_bn_conv``."""
    b = GraphBuilder()
    x = b.input("data")
    x = b.conv("c1", x, 3, 8, (3, 3), padding=(1, 1), bias=True)
    x = b.bn("bn1", x, 8)
    x = b.relu("r1", x)
    x = b.conv("c2", x, 8, 4, (1, 1), bias=True)
    g = b.build([x])
    return g, init_params(g, seed=seed, bn_stats="random")


def test_recon_data_reduces_loss():
    g, p = _tiny_conv_bn_conv()
    gt, pt = graph_from_jax(g), params_from_jax(p)
    cfg = ReconConfig(batch_size=4, num_batch=1, image_size=(16, 16), max_iters=40,
                      device="cpu")
    x0 = init_random_batch(np.random.default_rng(0),
                           DistillConfig(batch_size=4, image_size=(16, 16), max_value=1.0))
    x, it, last = recon_batch_fn(gt, pt, cfg)(x0)
    assert np.isfinite(last) and it > 0
    (b,) = recon_data(gt, pt, cfg, seed=0)
    assert b.shape == (4, 16, 16, 3) and np.isfinite(b).all()
    # against the JAX loop from the same seed batch: no clamp, so the
    # images may leave the seed range; the same steps, a loss within 1%
    xj, itj, lastj = j_recon_batch_fn(g, p, JReconConfig(
        batch_size=4, num_batch=1, image_size=(16, 16), max_iters=40))(x0)
    assert it == int(itj)
    assert last == pytest.approx(float(lastj), rel=1e-2)


def test_estimate_stats_matches_jax():
    g, p = _tiny_conv_bn_conv()
    rng = np.random.default_rng(2)
    batches = [rng.normal(size=(4, 8, 8, 3)).astype(np.float32) for _ in range(3)]
    got = estimate_stats(graph_from_jax(g), params_from_jax(p), batches, momentum=0.1,
                         num_epoch=2, device="cpu")
    want = j_estimate_stats(g, p, batches, momentum=0.1, num_epoch=2)
    assert got.keys() == want.keys()
    # the network-input site sees the raw images: its EMA in closed form
    lo = hi = 0.0
    for _ in range(2):
        for x in batches:
            flat = x.reshape(x.shape[0], -1)
            lo = lo * 0.9 + float(np.mean(flat.min(axis=1))) * 0.1
            hi = hi * 0.9 + float(np.mean(flat.max(axis=1))) * 0.1
    assert got["c1:in0"] == pytest.approx((lo, hi), rel=1e-5)
    assert got["c1:in0"] == want["c1:in0"]
    for site, (lo, hi) in want.items():
        step = (hi - lo) / 255.0
        assert abs(got[site][0] - lo) <= step and abs(got[site][1] - hi) <= step, site


def test_learn_scales_preserves_fp32_and_matches_jax():
    g, p = _tiny_conv_bn_conv(seed=3)
    x = np.random.default_rng(4).normal(size=(2, 8, 8, 3)).astype(np.float32)
    gt, pt = graph_from_jax(g), params_from_jax(p)
    with torch.no_grad():
        ref = execute(gt, pt, torch.from_numpy(x), device="cpu").numpy()

    g2, p2 = fold_batchnorm(gt, pt)
    rels = create_relations(gt)  # relations walk the pre-fold graph
    assert len(rels) >= 1
    merged, ranges, hist = learn_scales(g2, p2, rels, [x], num_epoch=2, device="cpu")
    assert len(hist) >= 1 and all(np.isfinite(h) for h in hist)
    # the reparameterization is an FP32 no-op (positive scales commute
    # with ReLU): the merged params keep the output
    with torch.no_grad():
        out = execute(g2, merged, torch.from_numpy(x), device="cpu").numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-4)
    assert all(np.isfinite(v) for r in ranges.values() for v in r)

    # the same steps in the JAX package
    gj2, pj2 = j_fold_batchnorm(g, p)
    mj, rj, hj = j_learn_scales(gj2, pj2, j_create_relations(g), [x], num_epoch=2)
    np.testing.assert_allclose(hist, hj, rtol=1e-4)
    assert merged.keys() == mj.keys()
    for k in mj:
        for n in mj[k]:
            np.testing.assert_allclose(merged[k][n], np.asarray(mj[k][n]), rtol=2e-3,
                                       atol=2e-4, err_msg=f"{k}.{n}")
    assert ranges.keys() == rj.keys()
    for site in rj:
        np.testing.assert_allclose(ranges[site], rj[site], rtol=2e-3, atol=2e-4)
