"""The fused engine's ``k3_matmul`` and ``b2s_min_h`` policies on the port
against the JAX package, on MobileNetV2 at 32x32 b2 (the method and
helpers of ``tests/test_torch_policies.py``): without kernels, the logits
0.0 apart from ``jax.jit(execute_int8_fused(**same))``'s; with the port's
kernels, 0.0 from its default net with its 11 / 5 / 12 launches. At
32x32, ``b2s_min_h=4`` folds the stem (32 rows) and every depthwise conv
on a map of 4 rows or more.

And the launches ``chip_smoke.py``'s phase 19 pins for its four paths at
full size under each kernel configuration, against the ``pallas_call``
equations of the JAX fused engine's trace (``jax.make_jaxpr``, which only
traces) with the graph's stride-2 depthwise convs added to K2's where the
kernels run, and the port's ``kernel_sites``."""

import pytest
import torch

from test_torch_policies import hold_conv_policy, mnv2  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("policy", ["im2col", "shift9", "b2s"])
def test_mobilenet_v2_policy_equals_jax(mnv2, policy):  # noqa: F811
    hold_conv_policy(mnv2, policy)


# -- the launches chip_smoke.py's phase 19 pins, against the JAX routing ----

def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROUTING_MODELS = {
    "mobilenet_v2": (lambda m: m.mobilenet_v2(), 224, False),
    "resnet18": (lambda m: m.resnet18(), 224, False),
    "ssd_lite": (lambda m: m.mobilenet_v2_ssd_lite(), 300, True),
    "deeplab_mnv2": (lambda m: m.deeplab_mobilenet_v2(), 513, False),
}
CONFIGS = {"default": {}, "unfused": {"fuse_blocks": False},
           "no_kernels": {"use_pallas": False},
           "no_kernels_unfused": {"use_pallas": False, "fuse_blocks": False}}


@pytest.mark.parametrize("name", sorted(ROUTING_MODELS))
def test_phase19_launches_equal_jax_routing(name):
    """``POLICY_LAUNCHES`` equals, per path and kernel configuration, the
    ``pallas_call`` equations of the JAX fused engine's trace at the
    path's full size with the graph's stride-2 depthwise convs added to
    K2's where the kernels run, and the port's ``kernel_sites`` under the same
    options; the conv policies of ``POLICIES`` leave the sites as the
    default's. Routing depends on the graph and on which site grids line
    up, so the models are lowered from a quick config."""
    import jax
    import jax.numpy as jnp

    import dfq_tpu.models as jm
    from dfq_tpu.engine.int8 import lower_int8 as j_lower_int8
    from dfq_tpu.engine.int8_fused import execute_int8_fused
    from dfq_tpu.models.common import init_params as j_init_params
    from dfq_tpu.pipeline import QuantConfig, prepare
    from dfq_tpu_torch.engine import Int8FusedNet
    from dfq_tpu_torch.interop import int8_model_from_jax
    from test_torch_policies import KERNELS, PORT_NAMES, pallas_counts, port_counts

    chip = _chip_smoke()
    build, size, det = ROUTING_MODELS[name]
    g = build(jm)
    flags = dict(delete_single=True, is_detection=True) if det else {}
    prep = prepare(g, j_init_params(g, seed=0, bn_stats="random"),
                   QuantConfig(quantize=True, relu=True, bits_bias=16, **flags))
    model = j_lower_int8(prep)
    tmodel = int8_model_from_jax(model)
    for config, opts in CONFIGS.items():
        jaxpr = jax.make_jaxpr(lambda v: execute_int8_fused(
            model, prep.params, v, stem_s2d=False, dw_dense_max_ch=0,
            **{"use_pallas": True, "fuse_blocks": True, **opts}))(jnp.zeros((1, size, size, 3)))
        counts = port_counts(pallas_counts(jaxpr), tmodel, opts.get("use_pallas", True))
        want = tuple(counts[k] for k in KERNELS)
        assert chip.POLICY_LAUNCHES[name][config] == want, config
        net = Int8FusedNet(tmodel, device="cpu", **{PORT_NAMES.get(k, k): v
                                                     for k, v in opts.items()})
        assert tuple(sum(1 for s in net.kernel_sites if s[1] == k) for k in KERNELS) == want
    default = [(n, k) for n, k, _ in Int8FusedNet(tmodel, device="cpu").kernel_sites]
    for label, opts in chip.POLICIES.items():
        if label not in CONFIGS:
            net = Int8FusedNet(tmodel, device="cpu", **opts)
            assert [(n, k) for n, k, _ in net.kernel_sites] == default, label
