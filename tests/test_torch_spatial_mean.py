"""The fused engine's spatial mean in XLA:CPU's summation order.

XLA:CPU marks the spatial mean's add ``reassoc``, and LLVM vectorizes it in
a way that depends on the map's width and on what the mean's loop also
computes (``Int8FusedNet``'s ``xla_cpu_mean_sum``). A quantized mean whose
sum lands on the other side of a rounding tie moves a logit by a grid step
times a weight, far above the JAX suite's 1e-4.

Held here against ``jax.jit(execute_int8_fused(..., use_pallas=True,
fuse_blocks=True))`` (Pallas in interpret mode), on the CPU:

- the mean step alone, at every map height from 2 to 16, behind a kernel
  (a pointwise conv at MobileNetV2's 1280 channels, as its head) and behind
  a fused residual add (3x3 convs at ResNet-18's 512 channels, as its last
  block): bit-equal logits;
- MobileNetV2 and ResNet-18 end to end at 128x128 and 256x256 (map heights
  4 and 8), batch 2: within the JAX suite's ``atol=1e-4`` with equal argmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfq_tpu.engine.int8 import lower_int8 as j_lower_int8
from dfq_tpu.engine.int8_fused import execute_int8_fused
from dfq_tpu.graph.ir import GraphBuilder
from dfq_tpu.models.common import init_params as j_init_params
from dfq_tpu.models.mobilenet_v2 import mobilenet_v2 as j_mobilenet_v2
from dfq_tpu.models.resnet import resnet18 as j_resnet18
from dfq_tpu.pipeline import QuantConfig, prepare
from dfq_tpu_torch.engine import Int8FusedNet
from dfq_tpu_torch.interop import int8_model_from_jax, params_from_jax

torch.set_num_threads(1)

FLAGSHIP = dict(quantize=True, relu=True, equalize=True, absorption=True,
                correction=True, bits_bias=16)


def _kernel_head():
    """MobileNetV2's head: a pointwise conv (K1) -> relu6 -> mean -> fc."""
    b = GraphBuilder()
    x = b.input("data")
    x = b.conv("c1", x, 3, 1280, (1, 1))
    x = b.bn("n1", x, 1280)
    x = b.relu6("r1", x)
    x = b.global_mean("gm", x)
    x = b.linear("fc", x, 1280, 10)
    return b.build([x])


def _residual_head():
    """ResNet-18's last block: 3x3 convs, the residual add, relu -> mean."""
    b = GraphBuilder()
    x = b.input("data")
    x = b.conv("c1", x, 3, 512, (3, 3), padding=(1, 1))
    x = b.bn("n1", x, 512)
    a = b.relu("r1", x)
    x = b.conv("c2", a, 512, 512, (3, 3), padding=(1, 1))
    x = b.bn("n2", x, 512)
    x = b.add("add", a, x)
    x = b.relu("r2", x)
    x = b.global_mean("gm", x)
    x = b.linear("fc", x, 512, 10)
    return b.build([x])


def _lowered(graph):
    prep = prepare(graph, j_init_params(graph, seed=0, bn_stats="random"),
                   QuantConfig(**FLAGSHIP))
    return prep, j_lower_int8(prep)


def _both(prep, model, x):
    want = np.asarray(jax.jit(lambda v: execute_int8_fused(
        model, prep.params, v, use_pallas=True, fuse_blocks=True))(jnp.asarray(x)))
    net = Int8FusedNet(int8_model_from_jax(model), device="cpu",
                       params_f32=params_from_jax(prep.params))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    return got, want


@pytest.fixture(scope="module")
def heads():
    return {"kernel": _lowered(_kernel_head()), "residual": _lowered(_residual_head())}


@pytest.mark.parametrize("producer", ["kernel", "residual"])
@pytest.mark.parametrize("h", list(range(2, 17)))
def test_mean_step_matches_jax(heads, producer, h):
    prep, model = heads[producer]
    x = np.random.default_rng(h).normal(0, 1, (2, h, h, 3)).astype(np.float32)
    got, want = _both(prep, model, x)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [128, 256])
@pytest.mark.parametrize("graph_fn", [j_mobilenet_v2, j_resnet18], ids=["mobilenet_v2", "resnet18"])
def test_models_match_jax(graph_fn, size):
    prep, model = _lowered(graph_fn())
    rng = np.random.default_rng(1)
    x = np.clip(rng.normal(0, 1, (2, size, size, 3)), -2.117, 2.64).astype(np.float32)
    got, want = _both(prep, model, x)
    assert got.shape == want.shape == (2, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
