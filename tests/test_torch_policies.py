"""The fused engine's lowering policies on the port against the JAX package.

- the policy helpers (``_s2d_weights``, ``_space_to_depth2``,
  ``_dense_diag_weights``, ``_chpad_target``, ``b2s_applicable``) equal
  JAX's, and the three conv rewrites (``int8_conv_b2s``, ``_im2col``,
  ``_shift9``) and ``int8_conv`` give int32 bit-equal to JAX's
  ``_int8_conv_b2s`` / ``_im2col`` / ``_shift9`` / ``_int8_conv`` at k3 s1
  p1, k3 s2 p1, k3 dilation 2 p2 and k1, on the CPU's float64 per-tap and
  per-patch products and on the int8 packings ``torch._int_mm`` takes;
- ``Int8FusedNet(device="cpu", **policy)`` against
  ``jax.jit(execute_int8_fused(**same))`` on MobileNetV2 at 32x32 b2: the
  logits 0.0 apart from JAX's and from the port's net without the policy
  (each is an exact rewrite), and the kernels' plain-version calls equal,
  per kernel, to the ``pallas_call`` equations of JAX's trace, K2's with
  the graph's stride-2 depthwise convs added where the kernels run (JAX
  runs them as XLA convs, the port on K2, bit for bit). Each conv
  policy here (``stem_s2d``,
  dense-diagonal depthwise at JAX's 32 channels and 160 rows,
  ``chpad_k3``) runs with neither kernels nor blocks on both sides (the
  JAX CLIs' default path, where it also reaches the pointwise and
  stride-1 depthwise convs; XLA compiles it in a third of the time Pallas
  in interpret mode takes), and again with the port's kernels, equal to
  its default net with its 11 / 5 / 12 launches (JAX's 11 / 1 / 12 and
  the 4 stride-2 depthwise convs);
  ``tests/test_torch_policies_configs.py`` holds ``k3_matmul`` and
  ``b2s_min_h`` the same way, and ``tests/test_torch_policies_kernels.py``
  the kernel configurations (``use_kernels``, ``fuse_blocks``) against
  JAX with Pallas in interpret mode;
- two small graphs with dense 3x3 convs (stride 2, dilation 2 at 256
  channels, and at 200 channels that ``chpad_k3`` pads to 256, so that
  ``k3_matmul="auto"`` reads the padded count, as JAX does) under every
  policy;
- ``"auto"`` resolved against ``per_device_batch``, and a ``k3_matmul``
  typo raising ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfq_tpu.engine.int8 as ji8
import dfq_tpu.engine.int8_fused as jf
from dfq_tpu.engine.int8 import lower_int8 as j_lower_int8
from dfq_tpu.graph.ir import GraphBuilder as JGraphBuilder
from dfq_tpu.graph.ir import Node as JNode
from dfq_tpu.models.common import init_params as j_init_params
from dfq_tpu.models.mobilenet_v2 import mobilenet_v2 as j_mobilenet_v2
from dfq_tpu.pipeline import QuantConfig, prepare
import dfq_tpu_torch.engine.int8 as ti8
import dfq_tpu_torch.engine.int8_fused as tf
from dfq_tpu_torch.engine import Int8FusedNet
from dfq_tpu_torch.graph.ir import Node
from dfq_tpu_torch.interop import int8_model_from_jax, params_from_jax
from dfq_tpu_torch.ops import cuda_int8 as ck

torch.set_num_threads(1)

KERNELS = ("matmul_int8_requant", "dw3x3_int8_requant", "fused_block_int8")
# the port's option name for JAX's use_pallas
PORT_NAMES = {"use_pallas": "use_kernels"}


# -- helpers shared with tests/test_torch_policies_configs.py --------------

def flagship_mnv2():
    g = j_mobilenet_v2()
    cfg = QuantConfig(quantize=True, relu=True, equalize=True, absorption=True,
                      correction=True, bits_bias=16)
    prep = prepare(g, j_init_params(g, seed=0, bn_stats="random"), cfg)
    rng = np.random.default_rng(3)
    x = np.clip(rng.normal(0, 1, (2, 32, 32, 3)), -2.117, 2.64).astype(np.float32)
    return prep, j_lower_int8(prep), x


def pallas_counts(jaxpr):
    """The ``pallas_call`` equations of a traced JAX forward, by kernel:
    K1's output is 2-D, K3 takes more than six operands
    (``tests/test_torch_zoo.py:_pallas_counts``)."""
    counts = dict.fromkeys(KERNELS, 0)

    def walk(j):
        for e in j.eqns:
            if e.primitive.name == "pallas_call":
                if len(e.params["out_avals"][0].shape) == 2:
                    counts["matmul_int8_requant"] += 1
                elif len(e.invars) > 6:
                    counts["fused_block_int8"] += 1
                else:
                    counts["dw3x3_int8_requant"] += 1
                continue
            for v in e.params.values():
                if hasattr(v, "eqns"):
                    walk(v)
                elif hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
                    walk(v.jaxpr)

    walk(jaxpr.jaxpr)
    return counts


def stride2_dw_sites(model) -> int:
    """The lowered 3x3 depthwise convs of stride 2 and padding 1 in the
    model's graph, read from the nodes' attributes: the port's K2 takes
    them beside the ``pallas_call`` sites of JAX's routing."""
    return sum(1 for n in model.graph if n.op == "conv" and n.name in model.layers
               and n.attrs["kernel"] == (3, 3)
               and n.attrs["groups"] == n.attrs["in_ch"] == n.attrs["out_ch"]
               and n.attrs["stride"] == (2, 2) and n.attrs["padding"] == (1, 1)
               and n.attrs["dilation"] == (1, 1))


def port_counts(counts, model, use_pallas: bool = True):
    """The port's calls per kernel for JAX's ``pallas_call`` ``counts``:
    K2's plus the stride-2 depthwise convs where the kernels run."""
    out = dict(counts)
    if use_pallas:
        out["dw3x3_int8_requant"] += stride2_dw_sites(model)
    return out


def jax_forward(model, params, x, **opts):
    """JAX's logits (one trace, compiled) and its pallas_call counts."""
    traced = jax.jit(lambda v: jf.execute_int8_fused(model, params, v, **opts)).trace(
        jnp.asarray(x))
    out = traced.lower().compile()(jnp.asarray(x))
    outs = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o) for o in outs], pallas_counts(traced.jaxpr)


def port_forward(tmodel, x, residual=None, **opts):
    """The port's outputs on the CPU and its plain-version calls."""
    ck.reset_counts()
    net = Int8FusedNet(tmodel, device="cpu", params_f32=residual, **opts)
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    calls = dict(ck.PLAIN_CALLS)
    outs = out if isinstance(out, tuple) else (out,)
    return [o.numpy() for o in outs], calls, net


def hold_policy(jmodel, jparams, tmodel, x, jax_opts, residual=None, default=None):
    """The port under ``jax_opts`` (JAX's names) against JAX: outputs 0.0
    apart, launches JAX's and the stride-2 depthwise convs; and 0.0 from
    the port's ``default`` outputs."""
    want, jax_counts = jax_forward(jmodel, jparams, x, **jax_opts)
    counts = port_counts(jax_counts, tmodel, jax_opts["use_pallas"])
    opts = {PORT_NAMES.get(k, k): v for k, v in jax_opts.items()}
    got, calls, net = port_forward(tmodel, x, residual, **opts)
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape and np.isfinite(g_).all()
        np.testing.assert_array_equal(g_, w_)
    if default is not None:
        for g_, d_ in zip(got, default):
            np.testing.assert_array_equal(g_, d_)
    assert calls == counts, (calls, counts)
    assert ck.LAUNCHES == dict.fromkeys(KERNELS, 0)
    assert {k: sum(1 for s in net.kernel_sites if s[1] == k) for k in KERNELS} == counts
    return calls


# the policies: JAX's option names, the batch-dependent ones explicit on
# both sides (JAX's "auto" is its TPU rule)
BASE = dict(use_pallas=True, fuse_blocks=True, stem_s2d=False, dw_dense_max_ch=0,
            chpad_k3=False)
# the JAX CLIs' default fused path: no kernel, no block
XLA = dict(BASE, use_pallas=False, fuse_blocks=False)
POLICIES = {
    "stem_s2d": dict(stem_s2d=True),
    # reaches MobileNetV2's 32-channel stride-1 depthwise conv (16x16 here)
    # where no kernel takes it
    "dense_dw": dict(dw_dense_max_ch=32, dw_dense_max_h=160),
    "chpad_k3": dict(chpad_k3=True),
    "im2col": dict(k3_matmul="im2col"),
    "shift9": dict(k3_matmul="shift9", k3_matmul_min_ch=0),
    "b2s": dict(b2s_min_h=4),
}
# JAX's pallas_call counts of the default configuration
DEFAULT_CALLS = {"matmul_int8_requant": 11, "dw3x3_int8_requant": 1, "fused_block_int8": 12}


@pytest.fixture(scope="module")
def mnv2():
    prep, model, x = flagship_mnv2()
    tmodel = int8_model_from_jax(model)
    default, calls, _ = port_forward(tmodel, x)
    assert stride2_dw_sites(tmodel) == 4
    assert calls == port_counts(DEFAULT_CALLS, tmodel)
    return prep, model, tmodel, x, default


def hold_conv_policy(mnv2, policy):
    """``policy`` without kernels against JAX (and against the port without
    kernels under no policy: an exact rewrite), and with the port's
    kernels against its default net (the kernel sites do not move)."""
    prep, model, tmodel, x, default = mnv2
    plain, _, _ = port_forward(tmodel, x, use_kernels=False, fuse_blocks=False)
    hold_policy(model, prep.params, tmodel, x, {**XLA, **POLICIES[policy]}, default=plain)
    got, calls, _ = port_forward(tmodel, x, **POLICIES[policy])
    np.testing.assert_array_equal(got[0], default[0])
    assert calls == port_counts(DEFAULT_CALLS, tmodel)


@pytest.mark.parametrize("policy", ["stem_s2d", "dense_dw", "chpad_k3"])
def test_mobilenet_v2_policy_equals_jax(mnv2, policy):
    hold_conv_policy(mnv2, policy)


# -- the helpers and the conv rewrites --------------------------------------

def test_s2d_and_dense_diag_weights_equal_jax():
    rng = np.random.default_rng(0)
    for shape in ((16, 3, 3, 3), (16, 3, 7, 7), (8, 5, 5, 5)):
        qw = rng.integers(-128, 128, shape).astype(np.int8)
        got, want = tf._s2d_weights(qw), jf._s2d_weights(qw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    qw = rng.integers(-128, 128, (24, 1, 3, 3)).astype(np.int8)
    got, want = tf._dense_diag_weights(qw), jf._dense_diag_weights(qw)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("pad", [1, 3])
def test_space_to_depth2_equals_jax(pad):
    x = np.random.default_rng(pad).integers(-128, 128, (2, 10, 10, 3)).astype(np.int8)
    got = tf._space_to_depth2(torch.from_numpy(x), -7, pad=pad).numpy()
    want = np.asarray(jf._space_to_depth2(jnp.asarray(x), -7, pad=pad))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_chpad_target_and_b2s_applicable_equal_jax():
    for cin in (1, 3, 4, 16, 64, 128, 129, 190, 200, 256, 304, 320, 600, 1024):
        for kernel in ((1, 1), (3, 3), (7, 7)):
            for groups in (1, 2):
                assert (tf._chpad_target(cin, kernel, groups)
                        == jf._chpad_target(cin, kernel, groups)), (cin, kernel, groups)
    for k, s, p, d in ((3, 1, 1, 1), (3, 2, 1, 1), (3, 1, 2, 2), (1, 1, 0, 1), (1, 2, 0, 1),
                       (7, 2, 3, 1), (2, 3, 1, 1)):
        attrs = {"kernel": (k, k), "stride": (s, s), "padding": (p, p),
                 "dilation": (d, d), "groups": 1, "in_ch": 4, "out_ch": 4}
        for h in (7, 8, 9, 10):
            assert (ti8.b2s_applicable(Node("c", "conv", ("x",), attrs), h)
                    == ji8._b2s_applicable(JNode("c", "conv", ("x",), attrs), h))


def _conv_case(k, s, p, d, groups=1, cin=10, cout=12, seed=0):
    attrs = {"kernel": (k, k), "stride": (s, s), "padding": (p, p), "dilation": (d, d),
             "groups": groups, "in_ch": cin, "out_ch": cout, "bias": False}
    rng = np.random.default_rng(seed + k * 7 + s * 3 + d)
    x = rng.integers(-128, 128, (3, 14, 14, cin)).astype(np.int8)
    qw = rng.integers(-128, 128, (cout, cin // groups, k, k)).astype(np.int8)
    return Node("c", "conv", ("x",), attrs), JNode("c", "conv", ("x",), attrs), x, qw


CASES = {"k3s1p1": (3, 1, 1, 1), "k3s2p1": (3, 2, 1, 1), "k3d2p2": (3, 1, 2, 2),
         "k1": (1, 1, 0, 1)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_rewrites_equal_jax(case):
    k, s, p, d = CASES[case]
    node, jnode, x, qw = _conv_case(k, s, p, d)
    zp = -37
    w_hwio = jnp.asarray(qw.transpose(2, 3, 1, 0))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(ji8._int8_conv(xj, jnode, w_hwio, zp))
    forms = {
        "conv": (ti8.int8_conv, "conv", None),
        "shift9": (ti8.int8_conv_shift9, "shift9", ji8._int8_conv_shift9),
        "im2col": (ti8.int8_conv_im2col, "im2col", ji8._int8_conv_im2col),
    }
    if ji8._b2s_applicable(jnode, x.shape[1]):
        forms["b2s"] = (ti8.int8_conv_b2s, "b2s", ji8._int8_conv_b2s)
    for form, (fn, pack_form, jfn) in forms.items():
        prod = ti8.pack_int8_product(qw, node, "cpu", pack_form)
        # the CPU's own path for each rewrite: float64 per tap or patch
        assert prod.route == {"conv": "f64", "b2s": "int_mm", "shift9": "int_mm",
                              "im2col": "im2col"}[form]
        assert form == "conv" or prod.w.dtype == torch.float64
        got = fn(xt, node, prod, zp).numpy()
        assert got.dtype == np.int32 and np.array_equal(got, want), form
        if jfn is not None:
            assert np.array_equal(np.asarray(jfn(xj, jnode, w_hwio, zp)), want), form
    # the int8 packings torch._int_mm takes on CUDA (K and N padded to 8)
    for fn, prod in ((ti8.int8_conv_shift9, ti8.pack_int_mm(qw, node, "cpu")),
                     (ti8.int8_conv_im2col, ti8.pack_im2col(qw, "cpu"))):
        assert prod.w.dtype == torch.int8 and prod.w.shape[-1] % 8 == 0
        assert np.array_equal(fn(xt, node, prod, zp).numpy(), want)
    if "b2s" in forms:
        prod = ti8.pack_int_mm(qw, node, "cpu")
        assert np.array_equal(ti8.int8_conv_b2s(xt, node, prod, zp).numpy(), want)


def test_b2s_grouped_and_rewrite_routes_checked():
    """The fold on a stride-2 depthwise conv (MobileNetV2's), and the
    named rewrites refusing a product packed for another form."""
    node, jnode, x, qw = _conv_case(3, 2, 1, 1, groups=10, cin=10, cout=10)
    zp = 11
    want = np.asarray(ji8._int8_conv_b2s(jnp.asarray(x), jnode,
                                         jnp.asarray(qw.transpose(2, 3, 1, 0)), zp))
    prod = ti8.pack_int8_product(qw, node, "cpu", "b2s")
    assert np.array_equal(ti8.int8_conv_b2s(torch.from_numpy(x), node, prod, zp).numpy(), want)
    node, _, x, qw = _conv_case(3, 1, 1, 1)
    with pytest.raises(ValueError, match="shift9"):
        ti8.int8_conv_shift9(torch.from_numpy(x), node,
                             ti8.pack_int8_product(qw, node, "cpu"), 0)
    with pytest.raises(ValueError, match="im2col"):
        ti8.int8_conv_im2col(torch.from_numpy(x), node,
                             ti8.pack_int8_product(qw, node, "cpu", "shift9"), 0)
    with pytest.raises(ValueError, match="form"):
        ti8.pack_int8_product(qw, node, "cpu", "winograd")


# -- small graphs with dense 3x3 convs ---------------------------------------

def _dense_graph(mid: int):
    """Stem k3s2 (3 channels), a dense k3 s1, a dense k3 s2 at ``mid``
    channels, a dilation-2 k3 at ``mid``, a stride-2 depthwise conv, and a
    1x1 head whose f32 map is the output."""
    b = JGraphBuilder()
    x = b.input("data")
    x = b.conv("stem", x, 3, 16, (3, 3), stride=(2, 2), padding=(1, 1))
    x = b.relu("stem.r", b.bn("stem.bn", x, 16))
    x = b.conv("c1", x, 16, mid, (3, 3), padding=(1, 1))
    x = b.relu("c1.r", b.bn("c1.bn", x, mid))
    x = b.conv("c2", x, mid, mid, (3, 3), stride=(2, 2), padding=(1, 1))
    x = b.relu("c2.r", b.bn("c2.bn", x, mid))
    x = b.conv("c3", x, mid, mid, (3, 3), padding=(2, 2), dilation=(2, 2))
    x = b.relu("c3.r", b.bn("c3.bn", x, mid))
    x = b.conv("dw", x, mid, mid, (3, 3), stride=(2, 2), padding=(1, 1), groups=mid)
    x = b.relu("dw.r", b.bn("dw.bn", x, mid))
    x = b.conv("head", x, mid, 10, (1, 1), bias=True)
    return b.build([x])


@pytest.fixture(scope="module", params=[256, 200])
def dense(request):
    g = _dense_graph(request.param)
    prep = prepare(g, j_init_params(g, seed=1, bn_stats="random"),
                   QuantConfig(quantize=True, relu=True, bits_bias=16))
    model = j_lower_int8(prep)
    x = np.clip(np.random.default_rng(2).normal(0, 1, (2, 24, 24, 3)), -2.1, 2.6
                ).astype(np.float32)
    tmodel = int8_model_from_jax(model)
    default, _, _ = port_forward(tmodel, x)
    return request.param, prep, model, tmodel, x, default


@pytest.mark.parametrize("policy", sorted(POLICIES) + ["auto_chpad", "dense256", "xla"])
def test_dense_graph_policy_equals_jax(dense, policy):
    mid, prep, model, tmodel, x, default = dense
    opts = {**(XLA if policy == "xla" else BASE), **POLICIES.get(policy, {})}
    if policy == "auto_chpad":
        # k3_matmul="auto" reads in_ch after chpad: 200 -> 256 qualifies
        opts.update(chpad_k3=True, k3_matmul="auto")
    if policy == "dense256":
        opts.update(dw_dense_max_ch=256, dw_dense_max_h=160)
    # the conv policies are exact rewrites: the default's outputs too
    hold_policy(model, prep.params, tmodel, x, opts,
                default=None if policy == "xla" else default)
    net = Int8FusedNet(tmodel, device="cpu", **{PORT_NAMES.get(k, k): v
                                                 for k, v in opts.items()})
    c3 = net.products["c3"].route
    shifted = (opts.get("k3_matmul", "auto") == "auto"
               and (mid == 256 or opts.get("chpad_k3")))
    if opts.get("k3_matmul") in ("shift9", "im2col"):
        assert c3 == {"shift9": "int_mm", "im2col": "im2col"}[opts["k3_matmul"]]
    else:
        assert c3 == ("int_mm" if shifted else "f64"), (policy, c3)


# -- "auto", per_device_batch, option checks ---------------------------------

def test_auto_resolves_against_per_device_batch(mnv2, monkeypatch):
    """With the port's ``auto_config`` given JAX's TPU rule, ``"auto"``
    resolves as JAX's does: against ``per_device_batch`` where given, else
    the forward's batch; one packed lowering a resolved policy."""
    prep, model, tmodel, x, default = mnv2
    monkeypatch.setattr(tf, "auto_config", jf.auto_config)
    net = Int8FusedNet(tmodel, device="cpu", use_kernels=False, fuse_blocks=False)
    assert net.policy(2) == tf.Policy(32, False, 128)
    assert net.policy(1) == tf.Policy(32, False, 160)
    assert net.policy(64) == tf.Policy(0, True, 0)
    for pdb in (None, 64):
        want, _ = jax_forward(model, prep.params, x, per_device_batch=pdb, chpad_k3=False)
        with torch.no_grad():
            got = net(torch.from_numpy(x), per_device_batch=pdb).numpy()
        np.testing.assert_array_equal(got, want[0])
        np.testing.assert_array_equal(got, default[0])
    assert set(net._lowerings) == {tf.Policy(32, False, 128), tf.Policy(0, True, 0)}
    # the module's own per_device_batch, and the sites of the policy run last
    net64 = Int8FusedNet(tmodel, device="cpu", per_device_batch=64)
    assert set(net64._lowerings) == {tf.Policy(0, True, 0)}
    with torch.no_grad():
        np.testing.assert_array_equal(net64(torch.from_numpy(x)).numpy(), default[0])
    assert net64.products["features.0.0"].w.shape[1] == 12  # the s2d stem


def test_port_auto_config_keeps_the_forward():
    for b in (1, 8, 64, 128):
        assert tf.auto_config(b) == (0, False)
        assert tf.resolve_policy(b) == tf.Policy(0, False, 0)


@pytest.mark.parametrize("typo", ["shift", "Im2col", "", "on"])
def test_k3_matmul_typo_raises(mnv2, typo):
    with pytest.raises(ValueError, match="k3_matmul"):
        Int8FusedNet(mnv2[2], device="cpu", k3_matmul=typo)
    with pytest.raises(ValueError, match="k3_matmul"):
        tf.execute_int8_fused(mnv2[2], {}, torch.zeros(1, 32, 32, 3), device="cpu",
                              k3_matmul=typo)


def test_execute_int8_fused_equals_module(mnv2):
    prep, model, tmodel, x, default = mnv2
    residual = params_from_jax({k: v for k, v in prep.params.items() if k not in model.layers})
    got = tf.execute_int8_fused(tmodel, residual, torch.from_numpy(x), device="cpu",
                                k3_matmul="im2col", stem_s2d=True)
    np.testing.assert_array_equal(got.numpy(), default[0])
