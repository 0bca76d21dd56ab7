"""The PyTorch port's batch statistics and batch norm
(apex_tpu_torch.ops.welford, parallel.sync_batchnorm) against the JAX
package's, on the CPU.

`channel_sums` is held against the JAX Pallas kernel, forced in
interpret mode as the JAX package's own test forces it (its
`_common._FORCE` switch, set for the test only); the rest against the
JAX functions.  The same seeded numpy inputs go to both; layout NHWC.

Tolerances.  fp32: sums rtol 1e-5 / atol 1e-4 (the JAX package's own
bound for the kernel, fp32 sums in another order); batch norm outputs,
gradients and running statistics 1e-5 of each array's largest
magnitude.  bf16 inputs: the statistics are fp32 sums of the same bf16
values (rtol 1e-5); the bf16 output within one bf16 ulp of the JAX
value plus 1e-6; the gradients, sums of bf16-rounded terms in both,
within 2e-2 of their largest magnitude (a few bf16 ulps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.ops._common as jax_common
from apex_tpu.ops import welford as JW
from apex_tpu.parallel import sync_batchnorm as JS
from apex_tpu_torch.ops import welford as W
from apex_tpu_torch.parallel import sync_batchnorm as S


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's plain versions on one CPU thread (as the other
    port tests do: once JAX has run in the process, torch's vector math
    on an intra-op worker thread is sometimes less accurate)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=1e-5, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.detach().float().numpy(), want, rtol=0,
        atol=rel * max(np.abs(want).max(), 1e-30), err_msg=what)


@pytest.mark.parametrize("rows,c", [(37, 16), (64, 3), (200, 130)])
def test_channel_sums_match_jax_pallas(rows, c, monkeypatch):
    """Forward against the forced Pallas kernel, and the gradient (ds +
    2·x·dq) against its custom_vjp."""
    rng = np.random.RandomState(rows + c)
    x = (rng.randn(rows, c) * 2 + 0.5).astype(np.float32)
    ds = rng.randn(c).astype(np.float32)
    dq = rng.randn(c).astype(np.float32)
    monkeypatch.setattr(jax_common, "_FORCE", "1")
    (ws, wq), vjp = jax.vjp(JW.channel_sums, jnp.asarray(x))
    (wdx,) = vjp((jnp.asarray(ds), jnp.asarray(dq)))
    xt = torch.tensor(x, requires_grad=True)
    s, q = W.channel_sums(xt)
    assert s.dtype == q.dtype == torch.float32 and s.shape == (c,)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(ws),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(wq),
                               rtol=1e-5, atol=1e-4)
    torch.autograd.backward((s, q), (torch.tensor(ds), torch.tensor(dq)))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wdx), rtol=1e-6,
                               atol=1e-6)


def test_channel_sums_of_bf16_are_fp32_and_the_grad_is_bf16():
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(50, 8).astype(np.float32)).astype(jnp.bfloat16)
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    ws, wq = JW.channel_sums(x)
    s, q = W.channel_sums(xt.requires_grad_(True))
    assert s.dtype == torch.float32
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(wq), rtol=1e-5,
                               atol=1e-4)
    (s.sum() + q.sum()).backward()
    assert xt.grad.dtype == torch.bfloat16


def test_batch_stats_match_jax():
    """NHWC, reducing (0, 1, 2) — a free (rows, C) view — and NCHW-style
    reductions over (0, 2, 3), permuted first."""
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 5, 6, 7) * 1.5 + 0.3).astype(np.float32)
    for axes in ((0, 1, 2), (0, 2, 3)):
        wm, wv, wc = JW.batch_stats(jnp.asarray(x), axes)
        m, v, c = W.batch_stats(torch.tensor(x), axes)
        assert c == wc
        _close(m, wm, what=f"mean {axes}")
        _close(v, wv, what=f"var {axes}")


def test_batch_stats_refuse_a_channels_first_tensor_seen_as_nhwc():
    """An NCHW-contiguous tensor permuted to NHWC has no (rows, C) view:
    it is refused, not copied behind the caller's back."""
    x = torch.zeros(2, 6, 4, 4).permute(0, 2, 3, 1)
    with pytest.raises(RuntimeError, match="view"):
        W.batch_stats(x, (0, 1, 2))


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_sync_batch_norm_matches_jax(training, dt):
    """Output, the gradients of x, scale and bias, and the new running
    statistics (unbiased variance) against jax.vjp of the JAX function."""
    rng = np.random.RandomState(3)
    c = 6
    x = (rng.randn(4, 3, 5, c) * 2 + 1).astype(np.float32)
    scale = rng.rand(c).astype(np.float32) + 0.5
    bias = rng.randn(c).astype(np.float32)
    rm = rng.randn(c).astype(np.float32) * 0.1
    rv = rng.rand(c).astype(np.float32) + 0.5
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jx = jnp.asarray(x).astype(jdt)
    xt = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)

    def jf(a, s, b):
        return JS.sync_batch_norm(a, s, b, jnp.asarray(rm), jnp.asarray(rv),
                                  training=training)

    (wy, wrm, wrv), vjp = jax.vjp(jf, jx, jnp.asarray(scale),
                                  jnp.asarray(bias))
    dy = rng.randn(*x.shape).astype(np.float32)
    wdx, wds, wdb = vjp((jnp.asarray(dy).astype(jdt), jnp.zeros_like(wrm),
                         jnp.zeros_like(wrv)))
    xt.requires_grad_(True)
    st = torch.tensor(scale, requires_grad=True)
    bt = torch.tensor(bias, requires_grad=True)
    y, nrm, nrv = S.sync_batch_norm(xt, st, bt, torch.tensor(rm),
                                    torch.tensor(rv), training=training)
    assert y.dtype == tdt and not nrm.requires_grad
    y.backward(torch.tensor(dy).to(tdt))
    _close(nrm, wrm, what="running mean")
    _close(nrv, wrv, what="running var")
    if dt == "f32":
        _close(y, wy.astype(jnp.float32), what="y")
        _close(xt.grad, wdx, what="dx")
    else:
        want = np.asarray(wy.astype(jnp.float32))
        _, e = np.frexp(np.abs(want))
        ulp = np.ldexp(np.ones_like(want), e - 8)
        assert np.all(np.abs(y.detach().float().numpy() - want)
                      <= ulp + 1e-6)
        # dx is a bf16 sum of bf16-rounded terms in both: 2 % of its
        # largest magnitude (a few bf16 ulps)
        _close(xt.grad, np.asarray(wdx.astype(jnp.float32)), rel=2e-2,
               what="dx")
    rel = 1e-5 if dt == "f32" else 2e-2
    _close(st.grad, wds, rel=rel, what="dscale")
    _close(bt.grad, wdb, rel=rel, what="dbias")


def test_module_facade_matches_the_function_and_updates_its_buffers():
    """forward() normalises with its own params and copies the new
    running statistics into its buffers in training mode only; init() and
    apply() are the JAX package's functional form."""
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.randn(8, 2, 2, 5).astype(np.float32))
    bn = S.SyncBatchNorm(5, device="cpu")
    params, state = bn.init(device="cpu")
    want, new_state = bn.apply(params, state, x, training=True)
    jbn = JS.SyncBatchNorm(5)
    jp, js = jbn.init()
    jy, jstate = jbn.apply(jp, js, jnp.asarray(x.numpy()), training=True)
    _close(want, jy)
    _close(new_state["running_var"], jstate["running_var"])
    got = bn(x)
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())
    np.testing.assert_array_equal(bn.running_mean.numpy(),
                                  new_state["running_mean"].numpy())
    bn.eval()
    before = bn.running_var.clone()
    bn(x)
    assert torch.equal(bn.running_var, before)
    assert set(n for n, _ in bn.named_parameters()) == {"scale", "bias"}


def test_convert_syncbn_model_and_merge_stats(monkeypatch):
    """convert_syncbn_model hands every SyncBatchNorm the group;
    merge_stats is the identity without a group and, with one, merges
    through one all-reduce (here a stand-in for two ranks holding the
    same statistics: the merged mean and variance are theirs, the count
    twice theirs).  Cross-rank merges with real gloo ranks:
    tests/test_torch_ddp.py."""
    net = torch.nn.Sequential(S.SyncBatchNorm(3, device="cpu"),
                              torch.nn.Sequential(
                                  S.SyncBatchNorm(4, device="cpu")))
    group = object()
    assert S.convert_syncbn_model(net, group) is net
    assert all(m.process_group is group for m in net.modules()
               if isinstance(m, S.SyncBatchNorm))
    m, v = torch.ones(3), torch.full((3,), 2.0)
    assert W.merge_stats(m, v, 10) == (m, v, 10)
    calls = []

    def two_equal_ranks(t, op=None, group=None, async_op=False):
        calls.append(group)
        return t.mul_(2)

    monkeypatch.setattr(torch.distributed, "all_reduce", two_equal_ranks)
    tm, tv, tn = W.merge_stats(m, v, 10, process_group=group)
    assert calls == [group]
    torch.testing.assert_close(tm, m)
    torch.testing.assert_close(tv, v)
    assert float(tn) == 20.0


def test_channel_sums_kernel_wrapper_refuses_strided_input():
    """The launch wrapper raises on what the kernel does not take, before
    any launch (here, on CPU tensors, before triton is imported)."""
    x = torch.zeros(8, 6)
    with pytest.raises(ValueError, match="contiguous"):
        W.channel_sums_cuda(x.t())
    with pytest.raises(ValueError, match="contiguous"):
        W.channel_sums_cuda(torch.zeros(2, 3, 4))
    with pytest.raises(TypeError, match="float"):
        W.channel_sums_cuda(torch.zeros(8, 6, dtype=torch.int32))


# -------------------------------- the CUDA plan -------------------------------

_H100_SMS = 132


@pytest.mark.parametrize("rows,c,itemsize,align", [
    (3_211_264, 64, 2, 16), (802_816, 256, 2, 16), (200_704, 512, 2, 16),
    (50_176, 1024, 2, 16), (12_544, 2048, 2, 16), (12_544, 2048, 4, 16),
    (12_544, 2048, 8, 16), (64, 3, 2, 16), (64, 3, 4, 4), (37, 16, 4, 16),
    (37, 16, 2, 2), (1000, 64, 2, 4), (0, 64, 2, 16), (1, 2048, 2, 16),
    (5000, 4096, 4, 16), (3_211_264, 3, 2, 2)])
def test_sums_plan(rows, c, itemsize, align):
    """`sums_plan` covers every row (blocks of `rows_per_block` rows) and
    every 16-byte vector of a row (column chunks of at most 256), in
    clusters of the most blocks (1-8) that divide their number, about a
    block an SM at most; 16-byte loads
    only where the rows' bytes and the base are 16-byte multiples, else
    one element a load; no more blocks than leave R x 8 rows a block
    (R = 256 / vectors of a chunk), so every thread has a full round of
    loads in flight."""
    plan = W.sums_plan(rows, c, itemsize, _H100_SMS, align)
    wide = align % 16 == 0 and c * itemsize % 16 == 0
    assert plan.load_width == (16 if wide else itemsize)
    vecs = c * itemsize // plan.load_width
    assert 1 <= plan.chunk <= W.SUMS_THREADS
    assert plan.col_blocks * plan.chunk >= vecs
    assert (plan.col_blocks - 1) * plan.chunk < vecs
    assert plan.chunk == min(vecs, W.SUMS_THREADS)
    if rows == 0:
        assert plan.blocks == 0
        return
    assert 1 <= plan.cluster <= W.SUMS_MAX_CLUSTER
    assert plan.blocks % plan.cluster == 0
    assert plan.blocks * plan.rows_per_block >= rows
    assert (plan.blocks - plan.cluster) * plan.rows_per_block < rows
    assert plan.blocks * plan.col_blocks <= (
        W.SUMS_BLOCKS_PER_SM * _H100_SMS + W.SUMS_MAX_CLUSTER
        * plan.col_blocks)
    slots = W.SUMS_THREADS // plan.chunk
    assert plan.blocks <= -(-rows // (slots * W.SUMS_UNROLL))
    assert not any(plan.blocks % c == 0 for c in range(
        plan.cluster + 1, W.SUMS_MAX_CLUSTER + 1))
    if (rows, c, itemsize, align) == (3_211_264, 64, 2, 16):
        assert plan == W.SumsPlan(132, 24328, 6, 1, 8, 16)
    if (rows, c, itemsize, align) == (12_544, 2048, 2, 16):
        assert plan == W.SumsPlan(132, 96, 6, 1, 256, 16)


def _sums_stand_in(monkeypatch, calls):
    """A stand-in for the kernel's C launch (`_launch`): it records the
    plan and fills the sums with the plain version."""
    def launch(plan, x2, s, q):
        calls.append(plan)
        assert s.shape == q.shape == (x2.shape[1],)
        assert s.dtype == q.dtype == torch.float32
        rs, rq = W.channel_sums_reference(x2)
        s.copy_(rs)
        q.copy_(rq)

    monkeypatch.setattr(W, "_launch", launch)
    monkeypatch.setattr(W, "_sm_count", lambda device: _H100_SMS)
    monkeypatch.setattr(W, "check_kernel_device", lambda *t: True)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows,c", [(37, 16), (64, 3), (200, 130),
                                    (1000, 64)])
def test_channel_sums_launcher_matches_jax_pallas(rows, c, dtype,
                                                  monkeypatch):
    """`channel_sums` of a CUDA tensor, with a recording stand-in for the
    C launch (on the CPU): one launch a call under `sums_plan`, and the
    sums (fp32, (C,)) match the JAX package's `channel_sums` with its
    Pallas kernel forced in interpret mode; the gradient is still the
    plain ds + 2·x·dq.  Tolerance: rtol 1e-5 / atol 1e-4 (fp32 sums in
    another order)."""
    calls = []
    _sums_stand_in(monkeypatch, calls)
    rng = np.random.RandomState(rows * 3 + c)
    x = (rng.randn(rows, c) * 2 + 0.5).astype(np.float32)
    jx = jnp.asarray(x)
    xt = torch.tensor(x)
    if dtype == "bf16":
        jx = jx.astype(jnp.bfloat16)
        xt = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
            torch.bfloat16)
    monkeypatch.setattr(jax_common, "_FORCE", "1")
    ws, wq = JW.channel_sums(jx)
    s, q = W.channel_sums(xt.requires_grad_(True))
    assert calls == [W.sums_plan(rows, c, xt.element_size(), _H100_SMS)]
    assert s.dtype == q.dtype == torch.float32 and s.shape == (c,)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(ws),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(wq),
                               rtol=1e-5, atol=1e-4)
    torch.autograd.backward((s, q), (torch.ones(c), torch.ones(c)))
    assert xt.grad.dtype == xt.dtype and xt.grad.shape == (rows, c)


def test_channel_sums_launcher_launches_nothing_for_empty_input(
        monkeypatch):
    calls = []
    _sums_stand_in(monkeypatch, calls)
    s, q = W.channel_sums_cuda(torch.zeros((0, 5)))
    assert calls == [] and torch.equal(s, torch.zeros(5))
    assert torch.equal(q, torch.zeros(5))
    with pytest.raises(TypeError, match="fp32/bf16/fp16/fp64"):
        W.channel_sums_cuda(torch.zeros((4, 5), dtype=torch.float8_e4m3fn))
