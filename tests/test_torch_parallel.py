"""The port's parallel package (``dfq_tpu_torch.parallel``) against the JAX
package's (``dfq_tpu.parallel``) on the CPU: every case of
``tests/test_parallel.py``, the JAX side on its 8-device CPU mesh and the
port's on a mesh of eight shards on the CPU (``["cpu"] * 8``), the same
numpy inputs through both.

Tolerances:

- sharded ``int8`` and ``fused`` logits: bit-equal to JAX's sharded and
  single-device outputs (and to the port's own single forward, also on
  uneven splits); counters and confusion matrices equal;
- sharded ``sim``: within ``tests/test_torch_executor.py``'s limit for the
  simulator without fake-quant sites (``rtol=1e-4, atol=1e-4``), and
  bit-equal to the port's single forward;
- tensor parallel: within ``atol=1e-4`` of JAX's ``make_tp_int8_forward``
  with equal argmax (the JAX suite's limit against its single-device
  engine), bit-equal to the port's single-device ``Int8Net``;
- the sharded distillation step in f32: the loss within ``rel=1e-6`` of
  JAX's (``tests/test_torch_calib.py``'s limit for the single-device
  loss) and the images ``x1`` after one Adam step within ``1e-6`` of
  their largest magnitude (that file's ``rtol=1e-6`` for an Adam step,
  taken of the largest value: where ``x0`` and the step of ``lr`` nearly
  cancel, an ulp of either is a larger share of the small result;
  measured 6e-9), and the loss falling.

It also holds the kernels' launch plumbing: a wrapper asks for the
stream of its input's device and launches with that device current.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfq_tpu.calib.distill import DistillConfig as JDistillConfig
from dfq_tpu.calib.distill import init_random_batch
from dfq_tpu.engine import execute_int8 as j_execute_int8
from dfq_tpu.engine import lower_int8 as j_lower_int8
from dfq_tpu.engine.int8_fused import execute_int8_fused as j_execute_int8_fused
from dfq_tpu.graph import GraphBuilder
from dfq_tpu.graph import execute as j_execute
from dfq_tpu.models import init_params
from dfq_tpu.parallel import data_mesh as j_data_mesh
from dfq_tpu.parallel import make_sharded_distill_step as j_distill_step
from dfq_tpu.parallel import make_sharded_eval as j_sharded_eval
from dfq_tpu.parallel import make_sharded_seg_eval as j_seg_eval
from dfq_tpu.parallel import make_streaming_eval as j_streaming_eval
from dfq_tpu.parallel import make_tp_int8_forward as j_tp_forward
from dfq_tpu.parallel import tp_mesh as j_tp_mesh
from dfq_tpu.parallel.eval import make_sharded_forward as j_sharded_forward
from dfq_tpu.passes import fold_batchnorm
from dfq_tpu.pipeline import QuantConfig, prepare
from dfq_tpu_torch import parallel as tp
from dfq_tpu_torch.calib.distill import DistillConfig
from dfq_tpu_torch.engine import Int8FusedNet, Int8Net
from dfq_tpu_torch.graph import execute
from dfq_tpu_torch.interop import graph_from_jax, int8_model_from_jax, params_from_jax
from dfq_tpu_torch.parallel import multihost
from dfq_tpu_torch.parallel.eval import make_sharded_forward
from dfq_tpu_torch.parallel.mesh import Sharded
from dfq_tpu_torch.parallel.tp import shard_int8_weights

torch.set_num_threads(1)
CPU8 = ["cpu"] * 8


def _net():
    """``tests/test_parallel.py``'s ``_net``."""
    b = GraphBuilder()
    x = b.input("data")
    x = b.conv("c1", x, 3, 8, (3, 3), stride=(2, 2), padding=(1, 1))
    x = b.bn("n1", x, 8)
    x = b.relu("r1", x)
    x = b.global_mean("gm", x)
    x = b.linear("fc", x, 8, 4)
    return b.build([x])


def _inv_res_net():
    """``tests/test_parallel.py``'s ``_inv_res_net``: pw expand -> dw 3x3
    -> pw project -> residual add."""
    b = GraphBuilder()
    x = b.input("data")
    x = b.conv("stem", x, 3, 8, (3, 3), stride=(2, 2), padding=(1, 1))
    x = b.bn("stem_bn", x, 8)
    x = b.relu6("stem_act", x)
    y = b.conv("exp", x, 8, 24, (1, 1))
    y = b.bn("exp_bn", y, 24)
    y = b.relu6("exp_act", y)
    y = b.conv("dw", y, 24, 24, (3, 3), padding=(1, 1), groups=24)
    y = b.bn("dw_bn", y, 24)
    y = b.relu6("dw_act", y)
    y = b.conv("proj", y, 24, 8, (1, 1))
    y = b.bn("proj_bn", y, 8)
    z = b.add("res", x, y)
    z = b.global_mean("gm", z)
    z = b.linear("fc", z, 8, 4)
    return b.build([z])


@pytest.fixture(scope="module")
def mesh():
    return j_data_mesh(), tp.data_mesh(devices=CPU8)


@pytest.fixture(scope="module")
def inv_res():
    """The flagship config on ``_inv_res_net``: JAX's prepared model and
    lowering, and the port's copies of both."""
    g = _inv_res_net()
    p = init_params(g, seed=0, bn_stats="random")
    prep = prepare(g, p, QuantConfig(quantize=True, relu=True, equalize=True, bits_bias=16))
    model = j_lower_int8(prep)
    return prep, model, graph_from_jax(prep.graph), params_from_jax(prep.params), \
        int8_model_from_jax(model)


def test_mesh_has_8_devices(mesh):
    jm, m = mesh
    assert jm.devices.size == m.size == 8 and m.shape == {"data": 8}
    assert m.distinct() == [torch.device("cpu")]
    assert len(tp.data_mesh(4, devices=CPU8).devices) == 4
    with pytest.raises(ValueError, match="requested a 9-device mesh"):
        tp.data_mesh(9, devices=CPU8)


def test_default_mesh_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.data_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.tp_mesh(2, 2)


def test_sharded_eval_matches_single_device(mesh):
    jm, m = mesh
    g = _net()
    p = init_params(g, seed=0, bn_stats="random")
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (16, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 4, 16).astype(np.int32)

    with jm:
        want = j_sharded_eval(g, p, jm)(jnp.asarray(x), jnp.asarray(labels))
    gt, pt = graph_from_jax(g), params_from_jax(p)
    got = tp.make_sharded_eval(gt, pt, m)(x, labels)
    assert got == want and got[1] == 16
    # the sim engine's logits: the simulator's limit against JAX, and
    # bit-equal to the port's single forward
    logits = make_sharded_forward(gt, pt, m)(x)
    j_logits = np.asarray(jax.jit(lambda pp, v: j_execute(g, pp, v))(p, jnp.asarray(x)))
    np.testing.assert_allclose(logits.gather().numpy(), j_logits, rtol=1e-4, atol=1e-4)
    single = execute(gt, pt, torch.from_numpy(x), device="cpu")
    assert torch.equal(logits.gather(), single)


def test_sharded_seg_eval_matches_host_evaluator(mesh):
    from dfq_tpu_torch.metrics import SegEvaluator

    jm, m = mesh
    b = GraphBuilder()
    x = b.input("data")
    x = b.conv("c1", x, 3, 8, (3, 3), padding=(1, 1))
    x = b.bn("n1", x, 8)
    x = b.relu("r1", x)
    x = b.conv("head", x, 8, 5, (1, 1))
    g = b.build([x])
    p = init_params(g, seed=3, bn_stats="random")
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (8, 12, 12, 3)).astype(np.float32)
    gt = rng.integers(0, 5, (8, 12, 12)).astype(np.int32)
    gt[rng.random(gt.shape) < 0.1] = 255  # ignore pixels outside [0, C)

    with jm:
        want = j_seg_eval(g, p, jm, num_class=5)(jnp.asarray(x), jnp.asarray(gt))
    gr, pr = graph_from_jax(g), params_from_jax(p)
    conf = tp.make_sharded_seg_eval(gr, pr, m, num_class=5)(x, gt)
    assert conf.dtype == np.int64 and conf.shape == (5, 5)
    np.testing.assert_array_equal(conf, want)
    ev = SegEvaluator(5)
    ev.add_batch(gt, execute(gr, pr, torch.from_numpy(x), device="cpu").argmax(-1).numpy())
    np.testing.assert_array_equal(conf, ev.confusion_matrix)
    assert conf.sum() < gt.size  # the ignore pixels were masked


@pytest.mark.parametrize("engine", ["int8", "fused"])
def test_sharded_int8_and_fused_match_single_device(engine, mesh, inv_res):
    """Bit-equal to JAX's sharded and single-device engines and to the
    port's single forward, on the even 8-way split and an uneven 3-way one
    (6/5/5); counters equal; the output's shards on all 8 devices."""
    jm, m = mesh
    prep, model, _, pt, mt = inv_res
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (16, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 4, 16).astype(np.int32)
    exec_fn = j_execute_int8 if engine == "int8" else j_execute_int8_fused
    oracle = np.asarray(jax.jit(lambda v: exec_fn(model, prep.params, v))(jnp.asarray(x)))
    with jm:
        j_sharded = np.asarray(j_sharded_forward(
            prep.graph, prep.params, jm, int8_model=model, engine=engine)(jnp.asarray(x)))
        j_counts = j_sharded_eval(prep.graph, prep.params, jm, int8_model=model,
                                  engine=engine)(jnp.asarray(x), jnp.asarray(labels))
    np.testing.assert_array_equal(j_sharded, oracle)

    out = make_sharded_forward(None, pt, m, int8_model=mt, engine=engine)(x)
    assert isinstance(out, Sharded) and len(out.shards) == 8 and len(out.devices) == 8
    assert all(s.shape == (2, 4) and s.device == d for s, d in zip(out.shards, out.devices))
    np.testing.assert_array_equal(out.gather().numpy(), oracle)
    single = (Int8Net(mt, pt, device="cpu") if engine == "int8"
              else Int8FusedNet(mt, device="cpu", params_f32=pt))
    with torch.no_grad():
        want = single(torch.from_numpy(x))
    m3 = tp.data_mesh(devices=["cpu"] * 3)
    uneven = make_sharded_forward(None, pt, m3, int8_model=mt, engine=engine)(x)
    assert [s.shape[0] for s in uneven.shards] == [6, 5, 5]
    assert torch.equal(uneven.gather(), want)
    got = tp.make_sharded_eval(None, pt, m, int8_model=mt, engine=engine)(x, labels)
    assert got == j_counts == (int((oracle.argmax(-1) == labels).sum()), 16)


def test_sharded_distill_step_runs_and_reduces(mesh):
    jm, m = mesh
    g = _net()
    p = init_params(g, seed=0, bn_stats="random")
    gf, pf = fold_batchnorm(g, p)
    # f32, as tests/test_torch_calib.py compares the single-device loss
    jcfg = JDistillConfig(batch_size=16, image_size=(16, 16), max_iters=1, compute_dtype="f32")
    x0 = init_random_batch(np.random.default_rng(0), jcfg)
    jstep, jinit = j_distill_step(gf, pf, jcfg, jm)
    with jm:
        jx, jst = jinit(jnp.asarray(x0))
        jx1, jst, jloss = jstep(jx, jst)
        jx2, _, jloss2 = jstep(jx1, jst)

    cfg = DistillConfig(batch_size=16, image_size=(16, 16), max_iters=1, compute_dtype="f32",
                        device="cpu")
    step, init = tp.make_sharded_distill_step(graph_from_jax(gf), params_from_jax(pf), cfg, m)
    x, st = init(x0)
    x1, st, loss = step(x, st)
    x2, _, loss2 = step(x1, st)
    assert np.isfinite(float(loss)) and np.isfinite(float(loss2))
    assert float(loss2) < float(loss)  # one Adam step reduces the loss
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    assert float(loss2) == pytest.approx(float(jloss2), rel=1e-6)
    jx1 = np.asarray(jx1)
    np.testing.assert_allclose(x1.gather().numpy(), jx1, rtol=0, atol=1e-6 * np.abs(jx1).max())
    # the image shards stay on the mesh
    assert len(x1.shards) == 8 and all(s.shape[0] == 2 for s in x1.shards)


def test_sharded_distill_loss_is_the_whole_batch_loss():
    """The shards' losses add up to the single-device loss of the whole
    batch (the input-statistics term divides by the global batch), and
    each shard's gradient is the whole loss's at its images."""
    from dfq_tpu_torch.calib.distill import loss_and_grad, make_loss_fn

    g = _net()
    gf, pf = fold_batchnorm(g, init_params(g, seed=0, bn_stats="random"))
    gt, pt = graph_from_jax(gf), params_from_jax(pf)
    cfg = DistillConfig(batch_size=12, image_size=(16, 16), compute_dtype="f32", device="cpu")
    x0 = torch.from_numpy(init_random_batch(np.random.default_rng(2), cfg))
    loss_fn, _ = make_loss_fn(gt, pt, cfg)
    want, grad = loss_and_grad(loss_fn, x0)
    parts = [loss_and_grad(lambda v: loss_fn(v, batch_size=12), s)
             for s in torch.tensor_split(x0, 3)]
    assert float(sum(p[0] for p in parts)) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(torch.cat([p[1] for p in parts]).numpy(), grad.numpy(),
                               rtol=0, atol=1e-6 * float(grad.abs().max()))


def test_adam_step_matches_plain_optax_adam():
    """The sharded step's optimizer is plain ``optax.adam(lr)`` (JAX's
    ``parallel/calib.py``), whose ``1 - b1`` is Python's float64 rounded to
    f32: ``AdamState(injected=False)`` follows its eager update to
    ``rtol=1e-6``, the limit ``tests/test_torch_calib.py`` holds the
    injected form to."""
    import optax

    from dfq_tpu_torch.calib.distill import AdamState, adam_step

    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 5, 5, 3)).astype(np.float32)
    opt = optax.adam(0.1)
    sj, xj = opt.init(jnp.asarray(x)), jnp.asarray(x)
    xt = torch.from_numpy(x.copy())
    st = AdamState.init(xt, 0.1, injected=False)
    for step in range(4):
        g = rng.normal(size=x.shape).astype(np.float32) * 10.0 ** (step - 2)
        upd, sj = opt.update(jnp.asarray(g), sj, xj)
        xj = optax.apply_updates(xj, upd)
        xt = adam_step(xt, torch.from_numpy(g), st)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6, atol=0)
        np.testing.assert_allclose(st.mu.numpy(), np.asarray(sj[0].mu), rtol=1e-6)
        np.testing.assert_allclose(st.nu.numpy(), np.asarray(sj[0].nu), rtol=1e-6)


def test_shard_and_replicate_placement(mesh):
    _, m = mesh
    xs = tp.shard_batch(m, np.zeros((16, 4), np.float32))
    assert len(xs.shards) == 8 and all(s.shape == (2, 4) for s in xs.shards)
    assert xs.devices == [torch.device("cpu")] * 8
    assert xs.gather().shape == (16, 4)
    p = tp.replicate(m, {"w": np.zeros((3, 3), np.float32)})
    assert list(p) == [torch.device("cpu")] and p[torch.device("cpu")]["w"].shape == (3, 3)
    with pytest.raises(ValueError, match="cannot be split over 8 shards"):
        tp.shard_batch(m, np.zeros((5, 4), np.float32))


def test_multihost_helpers_single_process():
    m = multihost.global_mesh(CPU8)
    assert m.size == 8
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.host_shard_bounds(100) == (0, 100)  # one process owns everything
    multihost.initialize(None, 1, 0, device="cpu")  # a no-op in one process
    assert not torch.distributed.is_initialized()
    arr = multihost.make_global_batch(m, np.ones((8, 4), np.float32))
    assert arr.shape == (8, 4) and float(arr.sum()) == 32.0


def test_checkpoint_roundtrip(tmp_path):
    """The JAX case with the port's checkpoints (npz + JSON; the JAX
    package's are orbax's)."""
    from dfq_tpu_torch.io.checkpoint import load_params, save_params

    p = init_params(_net(), seed=3, bn_stats="random")
    ranges = {"c1:in0": (-2.0, 2.0)}
    save_params(str(tmp_path / "ckpt"), p, ranges)
    p2, r2 = load_params(str(tmp_path / "ckpt"))
    np.testing.assert_array_equal(p2["c1"]["weight"], p["c1"]["weight"])
    assert r2 == ranges


def test_streaming_eval_matches_sharded(mesh, inv_res):
    """The depth-2 stream gives the sync loop's counters, and JAX's."""
    jm, m = mesh
    prep, model, _, pt, mt = inv_res
    rng = np.random.default_rng(3)
    batches = [(rng.normal(0, 1, (16, 16, 16, 3)).astype(np.float32),
                rng.integers(0, 4, 16).astype(np.int32)) for _ in range(5)]
    run_sync = tp.make_sharded_eval(None, pt, m, int8_model=mt, engine="int8")
    want = tuple(map(sum, zip(*(run_sync(x, lb) for x, lb in batches))))
    got = tp.make_streaming_eval(None, pt, m, int8_model=mt, engine="int8")(iter(batches))
    with jm:
        j_got = j_streaming_eval(prep.graph, prep.params, jm, int8_model=model,
                                 engine="int8")(iter(batches))
    assert got == want == j_got


def test_stream_counters_reads_depth_late():
    """Each counter is read ``depth`` steps after its step was queued."""
    reads, log = [], []

    class Counter:
        def __init__(self, i):
            self.i = i

        def __int__(self):
            reads.append((self.i, len(log)))
            return 1

    def step(x, labels):
        log.append(len(log))
        return Counter(len(log) - 1)

    batches = [(np.zeros((2, 1)), np.zeros(2)) for _ in range(5)]
    assert tp.stream.stream_counters(step, iter(batches), depth=2) == (5, 10)
    assert reads == [(0, 3), (1, 4), (2, 5), (3, 5), (4, 5)]


def test_tensor_parallel_int8_matches_single_device(inv_res):
    """Channel-sharded int8 over a 2x4 data x model mesh: within the JAX
    suite's limit of JAX's tensor-parallel forward with equal argmax,
    bit-equal to the port's single-device engine; the weights split on
    their output channel."""
    prep, model, _, pt, mt = inv_res
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (8, 16, 16, 3)).astype(np.float32)
    jm = j_tp_mesh(2, 4)
    with jm:
        want = np.asarray(j_tp_forward(model, prep.params, jm)(jnp.asarray(x)))
    m = tp.tp_mesh(2, 4, devices=CPU8)
    assert m.shape == {"data": 2, "model": 4}
    out = tp.make_tp_int8_forward(mt, pt, m)(x)
    assert len(out.shards) == 2
    got = out.gather().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    with torch.no_grad():
        single = Int8Net(mt, pt, device="cpu")(torch.from_numpy(x))
    assert torch.equal(out.gather(), single)
    qw = shard_int8_weights(mt, m)["exp"]["qweight"]  # HWIO, O = 24 over 4
    assert [tuple(s.shape) for s in qw] == [(1, 1, 8, 6)] * 4


@pytest.mark.parametrize("n_model", [5, 7])
def test_tensor_parallel_uneven_and_grouped_splits(n_model, inv_res):
    """Channel counts the model axis does not divide (24 over 5 or 7, 8
    over 7, 4 logits over 5 or 7 with empty shards) and a grouped conv with
    4 channels a group split off its group boundaries: bit-equal to the
    single-device engine."""
    from dfq_tpu_torch.engine import lower_int8 as t_lower_int8
    from dfq_tpu_torch.graph.ir import GraphBuilder as TBuilder
    from dfq_tpu_torch.models.common import init_params as t_init_params
    from dfq_tpu_torch.pipeline import QuantConfig as TQuantConfig
    from dfq_tpu_torch.pipeline import prepare as t_prepare

    _, _, _, pt, mt = inv_res
    x = np.random.default_rng(6).normal(0, 1, (2, 16, 16, 3)).astype(np.float32)
    m = tp.tp_mesh(1, n_model, devices=["cpu"] * n_model)
    with torch.no_grad():
        want = Int8Net(mt, pt, device="cpu")(torch.from_numpy(x))
    assert torch.equal(tp.make_tp_int8_forward(mt, pt, m)(x).gather(), want)

    b = TBuilder()
    h = b.input("data")
    h = b.conv("c1", h, 3, 8, (3, 3), padding=(1, 1))
    h = b.bn("n1", h, 8)
    h = b.relu("r1", h)
    h = b.conv("g2", h, 8, 8, (3, 3), padding=(1, 1), groups=2)
    h = b.bn("n2", h, 8)
    h = b.relu("r2", h)
    h = b.global_mean("gm", h)
    h = b.linear("fc", h, 8, 4)
    g = b.build([h])
    prep = t_prepare(g, t_init_params(g, seed=1, bn_stats="random"),
                     TQuantConfig(quantize=True, relu=True, bits_bias=16))
    lowered = t_lower_int8(prep)
    assert "g2" in lowered.layers
    with torch.no_grad():
        want = Int8Net(lowered, prep.params, device="cpu")(torch.from_numpy(x))
    got = tp.make_tp_int8_forward(lowered, prep.params, m)(x).gather()
    assert torch.equal(got, want)


def test_weights_override_rejects_a_wrong_channel_count(inv_res):
    _, _, _, pt, mt = inv_res
    w = shard_int8_weights(mt, tp.tp_mesh(1, 2, devices=["cpu"] * 2))
    w["exp"] = {k: v[:1] for k, v in w["exp"].items()}
    with pytest.raises(ValueError, match="exp: the weights override has 12 output channels"):
        Int8Net(mt, pt, device="cpu", weights=w)


def test_kernel_launch_asks_for_the_inputs_device(monkeypatch):
    """Each wrapper takes the current stream of its input's device and
    launches with that device current (not the current device's stream)."""
    from dfq_tpu_torch.ops import cuda_int8 as ck

    asked = []
    monkeypatch.setattr(ck, "_route", lambda x, name: True)
    monkeypatch.setattr(ck, "_sm_count", lambda device: ck.H100_SMS)
    monkeypatch.setattr(ck, "_fn", lambda name: lambda *args: 0)
    monkeypatch.setattr(ck, "_stream", lambda device: asked.append(("stream", device)) or 0)

    class Launch:
        def __init__(self, device):
            asked.append(("current", device))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(ck, "_launch_on", Launch)
    rng = np.random.default_rng(0)
    C, E, C2 = 8, 16, 8
    mm = ck.pack_matmul(rng.integers(-127, 128, (C2, C)), np.ones(C2), np.zeros(C2),
                        np.zeros(C2, np.int32), zp_in=0, s_out=1.0, zp_out=0, device="cpu")
    dw = ck.pack_dw3x3(rng.integers(-127, 128, (9, C)), np.ones(C), np.zeros(C), zp_in=0,
                       s_out=1.0, zp_out=0, device="cpu")
    dw2 = ck.pack_dw3x3(rng.integers(-127, 128, (9, C)), np.ones(C), np.zeros(C), zp_in=0,
                        s_out=1.0, zp_out=0, stride=2, device="cpu")
    g = (0.1, -128)
    fb = ck.pack_fused_block(
        rng.integers(-127, 128, (C, E)), np.ones(E), np.zeros(E), np.zeros(E, np.int32),
        rng.integers(-127, 128, (9, E)), np.ones(E), np.zeros(E),
        rng.integers(-127, 128, (E, C2)), np.ones(C2), np.zeros(C2), np.zeros(C2, np.int32),
        x_grid=g, c1_grid=g, e_grid=g, d_grid=g, act1_hi=6.0, act2_hi=6.0, out_grid=g,
        device="cpu")
    x = torch.zeros((2, 4, 4, C), dtype=torch.int8)
    ck.matmul_int8_requant_packed(x.reshape(-1, C), mm)
    ck.dw3x3_int8_requant_packed(x, dw)
    ck.dw3x3_int8_requant_packed(x, dw2)
    ck.fused_block_int8_packed(x, fb)
    assert asked == [("current", x.device), ("stream", x.device)] * 4
