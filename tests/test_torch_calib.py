"""ZeroQ calibration in the port (``dfq_tpu_torch.calib``) against the JAX
package (``dfq_tpu.calib``) on the CPU, on the JAX suite's small CNN
(``tests/test_calibration.py``): the same numpy inputs through both.

Tolerances (measured, then stated here):

- the distillation loss at the seed batch in f32: rtol 1e-6 (measured
  1.0e-7); its gradient within 1e-5 of its largest magnitude (measured
  1.9e-7): both sum the same terms in other orders;
- one Adam step: optax's form, ``rtol=1e-6``;
- the whole per-batch loop: the final loss within 1%, the same number of
  steps. The images are not compared pixel by pixel: Adam divides each
  step by the gradient's running magnitude, so a pixel whose gradient is
  tiny moves by up to ``lr`` a step on either side of a last-bit
  difference;
- ``calibrate_ranges``: every site within one fake-quant step
  ``(hi - lo) / 255`` of JAX's (a ``self_quant`` forward can flip a tie);
  the pinned input site exact;
- ``bias_correction_distill``: the bias within 1e-4 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfq_tpu.calib import bias_correction_distill as j_bias_correction_distill
from dfq_tpu.calib import calibrate_ranges as j_calibrate_ranges
from dfq_tpu.calib import distill as jd
from dfq_tpu.graph import GraphBuilder
from dfq_tpu.models import init_params
from dfq_tpu.passes import fold_batchnorm as j_fold_batchnorm
from dfq_tpu.passes import quantize_layer_weights as j_quantize_layer_weights
from dfq_tpu_torch.calib import bias_correction_distill, calibrate_ranges
from dfq_tpu_torch.calib import distill as td
from dfq_tpu_torch.interop import graph_from_jax, params_from_jax

torch.set_num_threads(1)


def _small_cnn():
    """``tests/test_calibration.py``'s ``_small_cnn``."""
    b = GraphBuilder()
    x = b.input("data")
    x = b.conv("c1", x, 3, 8, (3, 3), stride=(2, 2), padding=(1, 1))
    x = b.bn("n1", x, 8)
    x = b.relu("r1", x)
    x = b.conv("c2", x, 8, 12, (3, 3), stride=(2, 2), padding=(1, 1))
    x = b.bn("n2", x, 12)
    x = b.relu("r2", x)
    x = b.global_mean("gm", x)
    x = b.linear("fc", x, 12, 4)
    return b.build([x])


@pytest.fixture(scope="module")
def model():
    g = _small_cnn()
    p = init_params(g, seed=0, bn_stats="random")
    return g, p, graph_from_jax(g), params_from_jax(p)


def _configs(**kw):
    return jd.DistillConfig(**kw), td.DistillConfig(device="cpu", **kw)


def test_distill_loss_and_grad_match_jax(model):
    g, p, gt, pt = model
    cj, ct = _configs(batch_size=16, image_size=(16, 16), compute_dtype="f32")
    x0 = jd.init_random_batch(np.random.default_rng(0), cj)
    assert np.array_equal(x0, td.init_random_batch(np.random.default_rng(0), ct))
    loss_j, n_j = jd.make_loss_fn(g, p, cj)
    lj, gj = jax.value_and_grad(loss_j)(jnp.asarray(x0))
    loss_t, n_t = td.make_loss_fn(gt, pt, ct)
    lt, gt_ = td.loss_and_grad(loss_t, torch.from_numpy(x0))
    assert n_t == n_j == 2 and lt.dtype == torch.float32
    assert float(lt) == pytest.approx(float(lj), rel=1e-6)
    gj = np.asarray(gj)
    assert np.abs(gt_.numpy() - gj).max() <= 1e-5 * np.abs(gj).max()


def test_adam_step_matches_optax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 5, 5, 3)).astype(np.float32)
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=0.1)
    sj = opt.init(jnp.asarray(x))
    xj = jnp.asarray(x)
    xt = torch.from_numpy(x.copy())
    st = td.AdamState.init(xt, 0.1)
    for step in range(4):
        g = rng.normal(size=x.shape).astype(np.float32) * 10.0 ** (step - 2)
        upd, sj = opt.update(jnp.asarray(g), sj, xj)
        xj = optax.apply_updates(xj, upd)
        xt = td.adam_step(xt, torch.from_numpy(g), st)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6, atol=0)
        np.testing.assert_allclose(st.mu.numpy(), np.asarray(sj.inner_state[0].mu), rtol=1e-6)
        np.testing.assert_allclose(st.nu.numpy(), np.asarray(sj.inner_state[0].nu), rtol=1e-6)


def test_loop_bookkeeping_matches_jax(monkeypatch):
    """A scripted loss ``C + eps * a.x`` (``a`` of +-1): it falls by less
    than the plateau's relative threshold each step, so the learning rate
    is cut every ``patience + 1`` steps down to ``min_lr``, and its constant
    gradient moves every pixel by the step's learning rate (Adam's
    normalized step), so the final images record every cut. The loop
    breaks where the loss passes a threshold midway between two steps."""
    c, eps, patience, factor, min_lr, lr0 = 1.0, 1.5e-7, 3, 0.5, 0.02, 0.5
    a = np.random.default_rng(0).choice([-1.0, 1.0], size=(2, 4, 4, 3)).astype(np.float32)
    # the schedule the JAX loop's body gives: every step but the first is
    # a "bad" one (the whole run gains under 1e-4 relative); Adam moves a
    # pixel by r * lr, r = eps / (eps + 1e-8)
    r = eps / (eps + 1e-8)
    lrs, lr = [], lr0
    for step in range(40):
        lrs.append(lr)
        if step and step % (patience + 1) == 0:
            lr = max(lr * factor, min_lr)
    losses = c - eps * r * a.size * np.concatenate([[0.0], np.cumsum(lrs)])
    thr = float((losses[21] + losses[22]) / 2)  # passed at step 23
    kw = dict(batch_size=2, image_size=(4, 4), max_iters=40, lr=lr0, value_range=(-1e9, 1e9),
              plateau_patience=patience, plateau_factor=factor, min_lr=min_lr,
              early_break_factor=thr)
    cj, ct = _configs(**kw)
    monkeypatch.setattr(jd, "make_loss_fn", lambda g, p, cfg: (
        lambda x: c + eps * jnp.sum(jnp.asarray(a) * x), 0))
    x0 = np.zeros_like(a)
    xj, itj, lastj = jd.distill_batch_fn(None, None, cj)(jnp.asarray(x0))
    at = torch.from_numpy(a)
    xt, itt, lastt = td.optimize_batch(
        lambda x: c + eps * torch.sum(at * x), x0, lr=ct.lr, max_iters=ct.max_iters,
        threshold=thr, patience=patience, factor=factor, min_lr=min_lr, device="cpu")
    assert itt == int(itj) == 23
    assert lastt == pytest.approx(float(lastj), rel=1e-6)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6, atol=1e-7)
    # the cuts: each pixel moved by r times the sum of the 23 steps'
    # learning rates
    assert len(set(lrs[:23])) == 6
    np.testing.assert_allclose(-xt.numpy() * a, r * sum(lrs[:23]), rtol=1e-4)


def test_distill_batch_matches_jax(model):
    g, p, gt, pt = model
    cj, ct = _configs(batch_size=16, image_size=(16, 16), max_iters=300,
                      early_break_factor=0.3, lr=0.05, compute_dtype="f32")
    x0 = jd.init_random_batch(np.random.default_rng(0), cj)
    xj, itj, lastj = jd.distill_batch_fn(g, p, cj)(jnp.asarray(x0))
    xt, itt, lastt = td.distill_batch_fn(gt, pt, ct)(x0)
    assert xt.dtype == torch.float32 and tuple(xt.shape) == (16, 16, 16, 3)
    lo, hi = np.float32(ct.value_range[0]), np.float32(ct.value_range[1])
    assert float(xt.min()) >= lo and float(xt.max()) <= hi
    assert itt == int(itj)
    assert lastt == pytest.approx(float(lastj), rel=1e-2)


def test_distillation_matches_bn_stats(model):
    """The port's ``test_distillation_matches_bn_stats``: the distilled
    batch drives each BN input's mean toward the BN's running mean."""
    from dfq_tpu_torch.graph import execute

    _, p, gt, pt = model
    cfg = td.DistillConfig(batch_size=16, num_batch=1, image_size=(16, 16), max_iters=300,
                           early_break_factor=0.05, lr=0.05, device="cpu")
    (x,) = td.distill_data(gt, pt, cfg, seed=0)
    assert x.shape == (16, 16, 16, 3)
    x0 = np.random.default_rng(1).uniform(-2.1, 2.6, x.shape).astype(np.float32)
    with torch.no_grad():
        _, aux = execute(gt, pt, torch.from_numpy(x), capture="bn_inputs", device="cpu")
        _, aux0 = execute(gt, pt, torch.from_numpy(x0), capture="bn_inputs", device="cpu")
    for bn in ("n1", "n2"):
        err = np.abs(aux[bn][0].numpy().mean(0) - pt[bn]["mean"]).mean()
        err0 = np.abs(aux0[bn][0].numpy().mean(0) - pt[bn]["mean"]).mean()
        assert err < err0, (bn, err, err0)


def test_distill_bf16_converges_like_f32(model):
    _, _, gt, pt = model
    losses = {}
    for dt in ("f32", "bf16"):
        cfg = td.DistillConfig(batch_size=8, num_batch=1, image_size=(16, 16), max_iters=150,
                               early_break_factor=0.0, lr=0.05, compute_dtype=dt, device="cpu")
        x0 = td.init_random_batch(np.random.default_rng(0), cfg)
        x, it, loss = td.distill_batch_fn(gt, pt, cfg)(x0)
        assert x.dtype == torch.float32 and it == 150
        losses[dt] = loss
    assert np.isfinite(losses["bf16"])
    assert losses["bf16"] <= losses["f32"] * 1.25, losses


def test_distill_early_break(model):
    _, _, gt, pt = model
    cfg = td.DistillConfig(batch_size=4, num_batch=1, image_size=(16, 16), max_iters=50,
                           early_break_factor=1e6, device="cpu")
    _, it, _ = td.distill_batch_fn(gt, pt, cfg)(
        td.init_random_batch(np.random.default_rng(0), cfg))
    assert it <= 1


@pytest.fixture(scope="module")
def folded(model):
    g, p, _, _ = model
    gf, pf = j_fold_batchnorm(g, p)
    pq = j_quantize_layer_weights(gf, pf, bits_weight=4, bits_bias=32)
    rng = np.random.default_rng(3)
    batches = [rng.normal(0, 1, (8, 16, 16, 3)).astype(np.float32) for _ in range(3)]
    return gf, pf, pq, batches


def test_calibrate_ranges_matches_jax(folded):
    gf, pf, pq, batches = folded
    want = j_calibrate_ranges(gf, pq, batches)
    got = calibrate_ranges(graph_from_jax(gf), params_from_jax(pq), batches, device="cpu")
    assert got.keys() == want.keys()
    for site, (lo, hi) in want.items():
        step = (hi - lo) / 255.0
        assert abs(got[site][0] - lo) <= step and abs(got[site][1] - hi) <= step, site
    assert got["c1:in0"] == want["c1:in0"] == (-2.11790393, 2.64)
    det = calibrate_ranges(graph_from_jax(gf), params_from_jax(pq), batches[:1],
                           is_detection=True, device="cpu")
    assert det["c1:in0"] == (-1.0, 1.0)


def test_bias_correction_distill_matches_jax(folded):
    gf, pf, pq, batches = folded
    ranges = j_calibrate_ranges(gf, pq, batches[:2])
    want = j_bias_correction_distill(gf, pq, ranges, pf, batches[:2])
    got = bias_correction_distill(graph_from_jax(gf), params_from_jax(pq), ranges,
                                  params_from_jax(pf), batches[:2], device="cpu")
    assert got.keys() == want.keys()
    for name in want:
        if "bias" in want[name]:
            np.testing.assert_allclose(got[name]["bias"], np.asarray(want[name]["bias"]),
                                       rtol=0, atol=1e-4)
    # every layer moved by minus its mean output error
    moved = [n for n in want if "bias" in want[n]
             and not np.array_equal(np.asarray(want[n]["bias"]), pq[n].get("bias"))]
    assert set(moved) == {"c1", "c2", "fc"}
