"""The port's slice end to end vs the JAX package: full-width MobileNetV2,
the flagship DFQ config, ``lower_int8``, then the fused int8 engine.

The port's ``Int8FusedNet(device="cpu")`` (its kernels' plain versions)
is held against ``jax.jit(execute_int8_fused(..., use_pallas=True,
fuse_blocks=True))`` with the Pallas kernels in interpret mode, at the JAX
suite's own engine-vs-engine tolerance (``tests/test_int8_fused.py:102``:
``rtol=0, atol=1e-4``) and with equal argmax. Both engines compute from
identical numbers: the JAX ``Int8Model`` is carried across with
``dfq_tpu_torch.interop``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfq_tpu.engine.int8 import lower_int8 as j_lower_int8
from dfq_tpu.engine.int8_fused import execute_int8_fused
from dfq_tpu.models.common import init_params as j_init_params
from dfq_tpu.models.mobilenet_v2 import mobilenet_v2 as j_mobilenet_v2
from dfq_tpu.pipeline import QuantConfig, prepare
from dfq_tpu_torch.engine import Int8FusedNet
from dfq_tpu_torch.interop import int8_model_from_jax
from dfq_tpu_torch.ops import cuda_int8 as ck
from dfq_tpu_torch.serve import MicroBatcher
from test_torch_policies import port_counts

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flagship():
    g = j_mobilenet_v2()
    cfg = QuantConfig(quantize=True, relu=True, equalize=True, absorption=True,
                      correction=True, bits_bias=16)
    prep = prepare(g, j_init_params(g, seed=0, bn_stats="random"), cfg)
    model = j_lower_int8(prep)
    rng = np.random.default_rng(1)
    x = np.clip(rng.normal(0, 1, (2, 64, 64, 3)), -2.117, 2.64).astype(np.float32)
    return prep, model, x


def _jax_logits(prep, model, x, fuse_blocks):
    fn = jax.jit(lambda v: execute_int8_fused(
        model, prep.params, v, use_pallas=True, fuse_blocks=fuse_blocks))
    return np.asarray(fn(jnp.asarray(x)))


def test_slice_matches_jax_fused_engine(flagship):
    prep, model, x = flagship
    ref = _jax_logits(prep, model, x, fuse_blocks=True)
    tmodel = int8_model_from_jax(model)
    net = Int8FusedNet(tmodel, device="cpu")
    ck.reset_counts()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    # one forward routes JAX's 11 / 1 / 12 pallas_call sites through K1 /
    # K2 / K3, and the stride-2 depthwise convs through K2, all of them to
    # the plain versions on the CPU
    assert ck.PLAIN_CALLS == port_counts({"matmul_int8_requant": 11, "dw3x3_int8_requant": 1,
                                          "fused_block_int8": 12}, tmodel)
    assert ck.LAUNCHES == dict.fromkeys(ck.LAUNCHES, 0)
    assert [k for _, k, _ in net.kernel_sites].count("fused_block_int8") == 12


def test_unfused_blocks_match_jax_unfused_engine(flagship, monkeypatch):
    """Where a block does not fit K3, the engine runs it layer by layer
    (K1, K2, the int-domain relu and the residual add through the site
    grids), as the JAX engine does without block fusion."""
    prep, model, x = flagship
    ref = _jax_logits(prep, model, x, fuse_blocks=False)
    monkeypatch.setattr(ck, "fused_block_fits", lambda *a, **k: False)
    tmodel = int8_model_from_jax(model)
    net = Int8FusedNet(tmodel, device="cpu")
    ck.reset_counts()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    # 34 pointwise convs + the classifier on K1, the 13 stride-1 dw on K2
    # (JAX's pallas_call sites), and the stride-2 dw on K2
    assert ck.PLAIN_CALLS == port_counts({"matmul_int8_requant": 35, "dw3x3_int8_requant": 13,
                                          "fused_block_int8": 0}, tmodel)


def test_microbatcher_serves_rows_of_the_batch_forward(flagship):
    _, model, _ = flagship
    net = Int8FusedNet(int8_model_from_jax(model), device="cpu")
    rng = np.random.default_rng(5)
    images = np.clip(rng.normal(0, 1, (6, 32, 32, 3)), -2.117, 2.64).astype(np.float32)

    def forward(batch):
        with torch.no_grad():
            return net(torch.from_numpy(batch))

    direct = forward(images).numpy()
    batcher = MicroBatcher(forward, images[0], buckets=(2, 4), max_wait_ms=5.0)
    try:
        futs = [batcher.submit(images[i]) for i in range(6)]
        answers = [f.result(timeout=60) for f in futs]
        stats = batcher.stats()
    finally:
        batcher.stop()
    for i, a in enumerate(answers):
        np.testing.assert_array_equal(a, direct[i])
    assert stats.items == 6 and sum(
        b * n for b, n in stats.dispatch_sizes.items()) == stats.items + stats.padded
