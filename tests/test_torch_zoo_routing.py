"""The zoo's fused-engine kernel sites against the JAX routing (helpers
from ``tests/test_torch_zoo.py``): the port's plain-version calls in one
CPU forward equal, per kernel, the ``pallas_call`` equations of
``jax.make_jaxpr(execute_int8_fused(use_pallas=True, fuse_blocks=True))``
on the same lowered model, with K2 also at the graph's stride-2 depthwise
convs (JAX's XLA convs), for every new model (DeepLab at 65x65: routing
does not depend on the map size; SSD at 300x300, AlexNet at 224x224), and
so does the engine's ``kernel_sites`` list. The routing depends on the
graph and on which site grids line up, not on the range values, so these
models are lowered from a quick config (``quantize`` and ``relu``: no
equalization, whose iterations take tens of seconds on MobileNetV1) with
ranges carried from JAX (BN models: data-free; the BN-less SSD variants
and AlexNet, which the data-free range setter refuses as the reference
does: the same fixed range at every site).
"""

import pytest
import torch

from dfq_tpu.graph.ir import quant_sites as j_quant_sites
from dfq_tpu.engine.int8 import lower_int8 as j_lower_int8
from dfq_tpu.models.common import init_params as j_init_params
from dfq_tpu.pipeline import QuantConfig as JQuantConfig
from dfq_tpu.pipeline import prepare as j_prepare
import dfq_tpu.models as jm
from dfq_tpu_torch.engine import Int8FusedNet
from dfq_tpu_torch.interop import int8_model_from_jax, params_from_jax
from dfq_tpu_torch.ops import cuda_int8 as ck
from test_torch_policies import port_counts
from test_torch_zoo import DET, JAX_SITES, KERNELS, MODELS, _pallas_counts

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_kernel_sites_equal_jax_routing(name):
    build, size, det = MODELS[name]
    g = build(jm)
    kw = dict(quantize=True, relu=True, bits_bias=16, **(DET if det else {}))
    bn_less = name == "alexnet" or name.endswith("ssd") or name.endswith("lite")
    prep = j_prepare(g, j_init_params(g, seed=0, bn_stats="random"),
                     JQuantConfig(distill_range=bn_less, **kw))
    if bn_less:
        prep.act_ranges = {s: (-1.0, 3.0) for s in j_quant_sites(prep.graph)}
    model = j_lower_int8(prep)
    jax_counts = _pallas_counts(model, prep.params, size)
    assert tuple(jax_counts[k] for k in KERNELS) == JAX_SITES[name]

    tmodel = int8_model_from_jax(model)
    want = port_counts(jax_counts, tmodel)
    residual = params_from_jax({k: v for k, v in prep.params.items() if k not in model.layers})
    net = Int8FusedNet(tmodel, device="cpu", params_f32=residual)
    assert {k: sum(1 for _, kk, _ in net.kernel_sites if kk == k) for k in KERNELS} == want
    ck.reset_counts()
    with torch.no_grad():
        out = net(torch.zeros(1, size, size, 3))
    assert ck.PLAIN_CALLS == want and ck.LAUNCHES == dict.fromkeys(KERNELS, 0)
    outs = out if isinstance(out, tuple) else (out,)
    assert all(torch.isfinite(o).all() for o in outs)
