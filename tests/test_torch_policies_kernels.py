"""The fused engine's kernel configurations on the port against the JAX
package, on MobileNetV2 at 32x32 b2 (the method and helpers of
``tests/test_torch_policies.py``), with Pallas in interpret mode on the
JAX side: the default (``use_kernels``, ``fuse_blocks``: K1 / K2 / K3 at
11 / 1 / 12 ``pallas_call`` sites), ``fuse_blocks=False`` (K1 at the 34
pointwise convs and the classifier, K2 at the 13 stride-1 depthwise
convs) and ``use_kernels=False`` (JAX's ``use_pallas=False``: the 12
blocks still run on K3, as the JAX engine's do, and every other conv on
an exact integer conv). The logits are 0.0 apart from JAX's, and the
plain-version calls per kernel equal the ``pallas_call`` equations of
JAX's trace, with the 4 stride-2 depthwise convs added to K2's where the
kernels run (the port's K2 takes them, JAX's XLA convs). These
configurations are not held to the default's logits: their kernels round
a tie of the output scale's reciprocal in other forms than the default's
(K1 and K2 ``f32(1.0 / s)``, K3 and the glue ``f32(1 / f32(s))``), as
JAX's do, and MobileNetV2 at 224x224 has an image (seed 0, image 13)
where the two forms part by a grid step in both packages."""

import pytest
import torch

from test_torch_policies import BASE, hold_policy, mnv2, port_counts  # noqa: F401

torch.set_num_threads(1)

# JAX's pallas_call counts per configuration
CONFIGS = {
    "default": ({}, {"matmul_int8_requant": 11, "dw3x3_int8_requant": 1,
                     "fused_block_int8": 12}),
    "unfused": ({"fuse_blocks": False}, {"matmul_int8_requant": 35, "dw3x3_int8_requant": 13,
                                         "fused_block_int8": 0}),
    "no_kernels": ({"use_pallas": False}, {"matmul_int8_requant": 0, "dw3x3_int8_requant": 0,
                                           "fused_block_int8": 12}),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_mobilenet_v2_config_equals_jax(mnv2, config):  # noqa: F811
    prep, model, tmodel, x, default = mnv2
    opts, calls = CONFIGS[config]
    jax_opts = {**BASE, **opts}
    assert (hold_policy(model, prep.params, tmodel, x, jax_opts)
            == port_counts(calls, tmodel, jax_opts["use_pallas"]))
