"""The port's baseline int8 engine (``Int8Net`` / ``execute_int8``) vs the
JAX package's ``execute_int8`` under ``jax.jit``, and the exact int8
products it runs on.

Both engines compute from identical numbers: the JAX ``Int8Model`` and
params are carried across with ``dfq_tpu_torch.interop``. The tolerance
is the golden artifact's (``tests/test_golden_artifact.py:37``:
``rtol=0, atol=1e-5``) with equal argmax. Images of 64x64 and 96x96 end
in 2x2 and 3x3 feature maps: XLA:CPU sums the spatial mean of a
fake-quant in two different orders there (``engine/int8.py:
_spatial_sum``), and the quarter-grid means of a 2x2 map sit on rounding
ties, where that order decides the classifier's input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfq_tpu.engine.int8 import execute_int8 as j_execute_int8
from dfq_tpu.engine.int8 import lower_int8 as j_lower_int8
from dfq_tpu.models.common import init_params as j_init_params
from dfq_tpu.models.mobilenet_v2 import mobilenet_v2 as j_mobilenet_v2
from dfq_tpu.models.resnet import resnet18 as j_resnet18
from dfq_tpu.pipeline import QuantConfig, prepare
from dfq_tpu_torch.engine import int8 as ti8
from dfq_tpu_torch.engine import Int8Net, execute_int8
from dfq_tpu_torch.graph.ir import Node
from dfq_tpu_torch.interop import int8_model_from_jax, params_from_jax

torch.set_num_threads(1)

_CFG = dict(quantize=True, relu=True, equalize=True, absorption=True, correction=True,
            bits_bias=16)


def _lowered(name, **cfg):
    g = j_mobilenet_v2() if name == "mnv2" else j_resnet18()
    prep = prepare(g, j_init_params(g, seed=0, bn_stats="random"), QuantConfig(**cfg))
    return prep, j_lower_int8(prep)


def _images(n=2, size=96, seed=1):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(0, 1, (n, size, size, 3)), -2.117, 2.64).astype(np.float32)


def _compare(prep, model, x):
    want = np.asarray(jax.jit(lambda v: j_execute_int8(model, prep.params, v))(jnp.asarray(x)))
    net = Int8Net(int8_model_from_jax(model), params_from_jax(prep.params), device="cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=f"max abs {diff}")
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    return got


@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("name", ["mnv2", "r18"])
def test_baseline_engine_matches_jax(name, size):
    prep, model = _lowered(name, **_CFG)
    _compare(prep, model, _images(size=size))


@pytest.mark.parametrize("bits_act", [4, 6])
def test_narrow_activation_regimes(bits_act):
    """A4/A6 run through the baseline engine (the fused engine refuses them)."""
    prep, model = _lowered("r18", **{**_CFG, "bits_activation": bits_act})
    assert model.bits_act == bits_act
    _compare(prep, model, _images(size=64, seed=2))


def test_execute_int8_function_is_the_module():
    prep, model = _lowered("r18", **_CFG)
    x = torch.from_numpy(_images(seed=3))
    m, p = int8_model_from_jax(model), params_from_jax(prep.params)
    with torch.no_grad():
        a = Int8Net(m, p, device="cpu")(x)
    b = execute_int8(m, p, x, device="cpu")
    assert torch.equal(a, b)


def _conv_node(cin, cout, k, stride, dilation, groups=1, pad=None):
    pad = (k // 2 * dilation,) * 2 if pad is None else pad
    return Node("c", "conv", ("x",), {
        "in_ch": cin, "out_ch": cout, "kernel": (k, k), "stride": (stride, stride),
        "padding": pad, "dilation": (dilation, dilation), "groups": groups})


@pytest.mark.parametrize("cin,cout,k,stride,dilation,groups,n", [
    (256, 60, 3, 1, 1, 1, 2),    # K = 2304 > 1024, N not a multiple of 8
    (144, 24, 3, 2, 1, 1, 3),    # K = 1296, stride 2
    (130, 16, 3, 1, 2, 1, 2),    # K = 1170, dilation 2, Cin not a multiple of 8
    (512, 512, 3, 1, 1, 1, 1),   # layer4.x.conv2: K = 4608, M = 16 <= 16 (padded)
    (3, 64, 7, 2, 1, 1, 2),      # the ResNet stem shape, K = 147
    (1200, 1200, 1, 1, 1, 1200, 1),  # grouped: a group a matrix
    (64, 32, 3, 1, 1, 2, 2),     # 2 groups, K = 288
])
def test_shifted_view_int_gemm_is_exact(cin, cout, k, stride, dilation, groups, n):
    """The CUDA route of dense convs (k*k accumulated int8 GEMMs over
    shifted views of the zero-point-padded input, zero-padded to
    ``torch._int_mm``'s shape rule) is bit-equal to the float64 conv; here
    it runs on the CPU's ``torch._int_mm``."""
    rng = np.random.default_rng(cin + k)
    node = _conv_node(cin, cout, k, stride, dilation, groups)
    qw = rng.integers(-128, 128, (cout, cin // groups, k, k)).astype(np.int8)
    x = torch.from_numpy(rng.integers(-128, 128, (n, 4, 4, cin)).astype(np.int8))
    zp = -37
    want = ti8.int8_conv(x, node, ti8.pack_int8_product(qw, node, "cpu"), zp)
    prod = ti8.pack_int_mm(qw, node, "cpu")
    assert prod.w.shape[-2] % 8 == 0 and prod.w.shape[-1] % 8 == 0
    got = ti8.int8_conv(x, node, prod, zp)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(1, 1280, 1000), (3, 512, 1000), (8, 8, 10), (40, 147, 13)])
def test_linear_int_gemm_is_exact(m, k, n):
    """The baseline engine's linear layers on CUDA: one ``torch._int_mm``
    with M padded above 16 and K, N padded to multiples of 8."""
    rng = np.random.default_rng(m * k)
    node = Node("fc", "linear", ("x",), {"in_f": k, "out_f": n})
    qw = rng.integers(-128, 128, (n, k)).astype(np.int8)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    want = x.long() @ torch.from_numpy(qw).long().t()
    for prod in (ti8.pack_int8_product(qw, node, "cpu"), ti8.pack_int_mm(qw, node, "cpu")):
        got = ti8.int8_linear(x, prod)
        assert got.dtype == torch.int32 and torch.equal(got.long(), want)
