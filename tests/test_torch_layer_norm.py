"""The PyTorch port's LayerNorm/RMSNorm (apex_tpu_torch.ops.layer_norm)
against the JAX package's, on the CPU.

The JAX side runs its Pallas forward kernel in interpret mode
(`use_pallas_override=True`, as tests/test_layer_norm.py does); the
port's side runs its plain PyTorch version, which is what a CPU tensor
gets.  The same seeded numpy inputs go to both.  Tolerances: fp32 atol
1e-5; bf16 at most one bf16 ulp of the JAX value (both compute fp32
statistics and round once, but sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.layer_norm import fused_layer_norm as jax_layer_norm
from apex_tpu.ops.layer_norm import fused_rms_norm as jax_rms_norm
from apex_tpu_torch.ops import layer_norm as tln

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rows, hidden, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, hidden) * 2 + 0.5).astype(np.float32)
    w = (rng.randn(hidden) * 0.5 + 1).astype(np.float32)
    b = (rng.randn(hidden) * 0.1).astype(np.float32)
    return x, w, b


def _assert_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        # one bf16 ulp: 2^(e - 8) for want = m * 2^e, m in [0.5, 1)
        _, e = np.frexp(np.abs(want))
        ulp = np.ldexp(np.ones_like(want), e - 8)
        assert np.all(np.abs(got - want) <= ulp), np.max(
            np.abs(got - want) / ulp)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hidden", [32, 1024])
@pytest.mark.parametrize("rows", [5, 64])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_norm_matches_jax_pallas(kind, affine, rows, hidden, dtype):
    x, w, b = _inputs(rows, hidden, seed=rows * 7 + hidden)
    jdt, tdt = _DTYPES[dtype]
    jx, tx = jnp.asarray(x).astype(jdt), torch.tensor(x).to(tdt)
    jw = jnp.asarray(w).astype(jdt) if affine else None
    tw = torch.tensor(w).to(tdt) if affine else None
    if kind == "layer":
        jb = jnp.asarray(b).astype(jdt) if affine else None
        tb = torch.tensor(b).to(tdt) if affine else None
        want = jax_layer_norm(jx, jw, jb, use_pallas_override=True)
        got = tln.fused_layer_norm(tx, tw, tb)
    else:
        want = jax_rms_norm(jx, jw, use_pallas_override=True)
        got = tln.fused_rms_norm(tx, tw)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    _assert_close(got, want, dtype)


def test_stats_are_centred_fp32():
    """mean/rstd come out fp32 per row; the variance is centred, so a
    large common offset does not cancel catastrophically."""
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 256) + 1e4).astype(np.float32)
    y, mean, rstd = tln.norm_fwd_reference(torch.tensor(x))
    assert mean.dtype == rstd.dtype == torch.float32
    assert tuple(mean.shape) == tuple(rstd.shape) == (4, 1)
    xd = x.astype(np.float64)
    np.testing.assert_allclose(mean.numpy()[:, 0], xd.mean(1), rtol=1e-6)
    np.testing.assert_allclose(rstd.numpy()[:, 0],
                               1 / np.sqrt(xd.var(1) + 1e-5), rtol=1e-3)
    _, rmean, _ = tln.norm_fwd_reference(torch.tensor(x), rms=True)
    assert torch.equal(rmean, torch.zeros(4, 1))


def test_modules_match_functions_and_stay_on_cpu():
    """FusedLayerNorm/FusedRMSNorm are nn.Modules over the functions; a
    CPU tensor never reaches the kernel (its launch count stays put)."""
    x = torch.tensor(np.random.RandomState(0).randn(3, 5, 16)
                     .astype(np.float32))
    before = tln.norm_fwd_cuda.launches
    m = tln.FusedLayerNorm(16)
    assert [n for n, _ in m.named_parameters()] == ["weight", "bias"]
    torch.testing.assert_close(m(x), tln.layer_norm_reference(
        x, torch.ones(16), torch.zeros(16)), atol=0, rtol=0)
    r = tln.FusedRMSNorm(16, elementwise_affine=False)
    torch.testing.assert_close(r(x), tln.rms_norm_reference(x), atol=0,
                               rtol=0)
    y = tln.fused_layer_norm(x.requires_grad_(True))
    y.sum().backward()         # the plain version is differentiable
    assert x.grad is not None and x.grad.shape == x.shape
    assert tln.norm_fwd_cuda.launches == before


def test_kernel_dispatch_refuses_other_devices():
    """Dispatch follows the tensor's device: CPU → plain, CUDA → kernel,
    anything else (here the meta device, or mixed devices) raises."""
    with pytest.raises(ValueError, match="CPU"):
        tln.fused_layer_norm(torch.empty(2, 8, device="meta"))
    with pytest.raises(ValueError, match="CPU"):
        tln.fused_layer_norm(torch.ones(2, 8),
                             torch.ones(8, device="meta"))


def _ulp_close(got, want, slack):
    """|got - want| <= one bf16 ulp of want + slack (fp32 differences
    from summing in another order, before the one rounding to bf16)."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    _, e = np.frexp(np.abs(want))
    ulp = np.ldexp(np.ones_like(want), e - 8)
    assert np.all(np.abs(got - want) <= ulp + slack), np.max(
        np.abs(got - want) - ulp)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_backward_matches_jax_pallas(kind, dtype):
    """dx, dw (and db) through torch.autograd against jax.vjp of the JAX
    package's norm with its Pallas backward kernel in interpret mode.
    Tolerances: fp32 dx atol 1e-5, dw/db rtol 1e-5 over sums of 37
    rows; bf16 one bf16 ulp plus 1e-5 of slack for the fp32 sums."""
    rows, hidden = 37, 256
    x, w, b = _inputs(rows, hidden, seed=5)
    g = np.random.RandomState(6).randn(rows, hidden).astype(np.float32)
    jdt, tdt = _DTYPES[dtype]
    jx, jw, jb, jg = (jnp.asarray(a).astype(jdt) for a in (x, w, b, g))
    tx, tw, tb = (torch.tensor(a).to(tdt).requires_grad_(True)
                  for a in (x, w, b))
    if kind == "layer":
        _, vjp = jax.vjp(lambda x_, w_, b_: jax_layer_norm(
            x_, w_, b_, use_pallas_override=True), jx, jw, jb)
        want = vjp(jg)
        tln.fused_layer_norm(tx, tw, tb).backward(torch.tensor(g).to(tdt))
        got = (tx.grad, tw.grad, tb.grad)
    else:
        _, vjp = jax.vjp(lambda x_, w_: jax_rms_norm(
            x_, w_, use_pallas_override=True), jx, jw)
        want = vjp(jg)
        tln.fused_rms_norm(tx, tw).backward(torch.tensor(g).to(tdt))
        got = (tx.grad, tw.grad)
    for i, (gt, wt) in enumerate(zip(got, want)):
        assert gt.dtype == tdt
        if dtype == "bf16":
            _ulp_close(gt, wt, 1e-5 * float(jnp.max(jnp.abs(
                wt.astype(jnp.float32)))))
        elif i == 0:
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                       atol=1e-5, rtol=0)
        else:
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rms", [False, True])
def test_bwd_reference_is_the_gradient(rms):
    """`norm_bwd_reference` (the plain version the CUDA kernel is held
    against) is the gradient autograd takes through the plain forward:
    fp32, atol 1e-5; dw/db fp32 whatever the input dtype."""
    x, w, b = _inputs(19, 64, seed=8)
    g = torch.tensor(np.random.RandomState(9).randn(19, 64)
                     .astype(np.float32))
    tx, tw, tb = (torch.tensor(a).requires_grad_(True) for a in (x, w, b))
    y, mean, rstd = tln.norm_fwd_reference(tx, tw, None if rms else tb,
                                           rms=rms)
    y.backward(g)
    dx, dw, db = tln.norm_bwd_reference(g, tx.detach(), mean.detach(),
                                        rstd.detach(), tw.detach(), rms)
    torch.testing.assert_close(dx, tx.grad, atol=1e-5, rtol=0)
    torch.testing.assert_close(dw, tw.grad, atol=1e-5, rtol=1e-6)
    if not rms:
        torch.testing.assert_close(db, tb.grad, atol=1e-5, rtol=1e-6)
    _, dw_none, db_none = tln.norm_bwd_reference(g, tx.detach(), mean,
                                                 rstd, None, rms)
    assert dw_none is None and db_none is None


# ------------------------------ the CUDA plan -------------------------------

_H100_SMS = 132


def _groups(plan):
    """Row groups a block."""
    assert plan.warps % plan.warps_per_row == 0
    return plan.warps // plan.warps_per_row


@pytest.mark.parametrize("rows,hidden,itemsize,align", [
    (12288, 1024, 2, 16), (16384, 1024, 2, 16), (77, 1000, 4, 16),
    (5, 1024, 2, 16), (1, 16384, 2, 16), (0, 1024, 2, 16),
    (77, 1001, 2, 16), (77, 1000, 4, 4), (3, 16384, 4, 16), (3, 8200, 2, 16),
    (33, 2048, 4, 16), (12288, 1024, 2, 4)])
def test_bwd_plan(rows, hidden, itemsize, align):
    """`bwd_plan` covers every row exactly once (blocks of
    `rows_per_block` rows, each row group taking every `groups`-th row of
    its block's run, as the kernel walks them), at most one block an SM;
    a row's threads hold at most 32 columns (48 on the 12 warps of a row
    past 8192 columns); the finishing pass takes at
    least one block an SM wherever hidden has the 4-column slices for it;
    16-byte loads (bulk copies into a ring) only where the rows' bytes
    and bases are 16-byte multiples, one slot otherwise; the ring and w's
    fp32 row fit the 227 KB a block may take; a block has 8 warps (a
    row's, when it takes more)."""
    plan = tln.bwd_plan(rows, hidden, itemsize, _H100_SMS, align)
    groups = _groups(plan)
    if plan.warps_per_row == tln.BWD_WIDE_WARPS:
        assert hidden > tln.BWD_WARPS * 32 * tln.BWD_COLS
    else:
        assert hidden <= plan.warps_per_row * 32 * tln.BWD_COLS
        assert plan.warps_per_row == 1 or hidden > (
            plan.warps_per_row // 2 * 32 * tln.BWD_COLS)
    seen = np.zeros(rows, np.int64)
    for b in range(plan.blocks):
        r0 = b * plan.rows_per_block
        end = min(r0 + plan.rows_per_block, rows)
        assert end > r0
        for g in range(groups):
            seen[r0 + g:end:groups] += 1
    assert np.all(seen == 1)
    assert plan.blocks <= _H100_SMS
    assert plan.finish_blocks == -(-hidden // tln.BWD_FINISH_COLS)
    if hidden >= _H100_SMS * tln.BWD_FINISH_COLS:
        assert plan.finish_blocks >= _H100_SMS
    wide = align % 16 == 0 and hidden * itemsize % 16 == 0
    assert (plan.load_width == 16) == wide
    if not wide:
        assert plan.stages == 1 and plan.load_width in (4, 2)
        assert plan.load_width == 2 or hidden * itemsize % 4 == 0
    ring = groups * plan.stages * 2 * -(-hidden * itemsize // 16) * 16
    assert 1 <= plan.stages <= tln.BWD_MAX_STAGES
    assert ring + hidden * 4 <= tln.BWD_SMEM or plan.stages == 1
    assert ring + hidden * 4 < 227 * 1024
    assert plan.warps == max(plan.warps_per_row, tln.BWD_WARPS)
    if (rows, hidden) == (12288, 1024) and wide:
        assert plan == tln.BwdPlan(128, 96, 8, 1, 4, 16, 256)


@pytest.mark.parametrize("hidden", [0, 16385])
def test_bwd_plan_refuses_what_the_kernel_cannot_hold(hidden):
    with pytest.raises(ValueError, match="hidden"):
        tln.bwd_plan(8, hidden, 2, _H100_SMS)


def _bwd_stand_in(monkeypatch, calls):
    """Stand-ins for the card: the forward kernel runs its plain version,
    the backward's C launch (`_launch`) records its plan and fills dx and
    (dw, db) with the plain backward."""
    def fwd(x2, weight, bias, eps, rms):
        return tln.norm_fwd_reference(x2, weight, bias, eps, rms)

    def launch(plan, g2, x2, mean, rstd, weight, dx, dwdb, rms):
        calls.append(plan)
        assert dx.shape == x2.shape and dx.dtype == x2.dtype
        rdx, rdw, rdb = tln.norm_bwd_reference(g2, x2, mean, rstd, weight,
                                               rms)
        dx.copy_(rdx)
        if weight is None:
            assert dwdb is None
        else:
            assert dwdb.shape == (2, x2.shape[1])
            assert dwdb.dtype == torch.float32
            dwdb[0].copy_(rdw)
            dwdb[1].copy_(rdb)

    monkeypatch.setattr(tln, "norm_fwd_cuda", fwd)
    monkeypatch.setattr(tln, "_launch", launch)
    monkeypatch.setattr(tln, "_sm_count", lambda device: _H100_SMS)
    monkeypatch.setattr(tln, "check_kernel_device", lambda *t: True)


@pytest.mark.parametrize("weight", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rms", [False, True])
def test_bwd_launcher_matches_jax_bwd_pallas(rms, dtype, weight,
                                             monkeypatch):
    """`norm_bwd_cuda` with a recording stand-in for its C launch (on the
    CPU): one launch under `bwd_plan`, and its outputs (dx in x's dtype,
    fp32 dw and db, or None without a weight) match the JAX package's
    `_bwd_pallas` (its Pallas backward in interpret mode) on the same
    inputs.  Tolerances as the autograd test's: fp32 dx atol 1e-5, dw/db
    rtol 1e-5; bf16 one ulp plus 1e-5 of the largest magnitude."""
    from apex_tpu.ops.layer_norm import _bwd_pallas

    calls = []
    _bwd_stand_in(monkeypatch, calls)
    rows, hidden = 37, 256
    x, w, _ = _inputs(rows, hidden, seed=11)
    g = np.random.RandomState(12).randn(rows, hidden).astype(np.float32)
    jdt, tdt = _DTYPES[dtype]
    tx, tw, tg = (torch.tensor(a).to(tdt) for a in (x, w, g))
    _, mean, rstd = tln.norm_fwd_reference(tx, tw, None, rms=rms)
    tw = tw if weight else None
    got = tln.norm_bwd_cuda(tg, tx, mean, rstd, tw, rms)
    assert calls == [tln.bwd_plan(rows, hidden, tx.element_size(),
                                  _H100_SMS)]
    want = _bwd_pallas(jnp.asarray(g).astype(jdt), jnp.asarray(x).astype(jdt),
                       jnp.asarray(mean.numpy()), jnp.asarray(rstd.numpy()),
                       jnp.asarray(w).astype(jdt) if weight else None, rms)
    assert got[0].dtype == tdt
    if not weight:
        assert got[1] is None and got[2] is None and want[1] is None
    for i, (gt, wt) in enumerate(zip(got, want)):
        if gt is None:
            continue
        if i:
            assert gt.dtype == torch.float32
        if dtype == "bf16" and i == 0:
            _ulp_close(gt, wt, 1e-5 * float(jnp.max(jnp.abs(
                wt.astype(jnp.float32)))))
        elif i == 0:
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                       atol=1e-5, rtol=0)
        else:
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_norm_fn_routes_its_backward_to_the_cuda_launcher(kind,
                                                          monkeypatch):
    """The autograd route of a CUDA call, with stand-ins for the kernels
    (on the CPU): the backward launches once, under the plan of a 16-byte
    load width at (37, 256), and the grads match jax.vjp of the JAX
    package's norm with its Pallas backward in interpret mode (fp32:
    dx atol 1e-5, dw/db rtol 1e-5).  Zero rows launch nothing and give
    zero dw/db."""
    calls = []
    _bwd_stand_in(monkeypatch, calls)
    x, w, b = _inputs(37, 256, seed=13)
    g = np.random.RandomState(14).randn(37, 256).astype(np.float32)
    tx, tw, tb = (torch.tensor(a).requires_grad_(True) for a in (x, w, b))
    jx, jw, jb, jg = (jnp.asarray(a) for a in (x, w, b, g))
    if kind == "layer":
        _, vjp = jax.vjp(lambda x_, w_, b_: jax_layer_norm(
            x_, w_, b_, use_pallas_override=True), jx, jw, jb)
        tln.fused_layer_norm(tx, tw, tb).backward(torch.tensor(g))
        got = (tx.grad, tw.grad, tb.grad)
    else:
        _, vjp = jax.vjp(lambda x_, w_: jax_rms_norm(
            x_, w_, use_pallas_override=True), jx, jw)
        tln.fused_rms_norm(tx, tw).backward(torch.tensor(g))
        got = (tx.grad, tw.grad)
    assert len(calls) == 1 and calls[0].load_width == 16
    for i, (gt, wt) in enumerate(zip(got, vjp(jg))):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                   atol=1e-5, rtol=0 if i == 0 else 1e-5)
    calls.clear()
    empty = torch.zeros((0, 256))
    dx, dw, db = tln.norm_bwd_cuda(empty, empty, torch.zeros((0, 1)),
                                   torch.zeros((0, 1)), tw.detach(), False)
    assert calls == [] and dx.shape == (0, 256)
    assert torch.equal(dw, torch.zeros(256)) and torch.equal(db, dw)


# ----------------------------- the forward plan ------------------------------

# warps a row the plan gives each width of 16-bit rows of 16-byte
# multiples (a 16-byte vector a thread up to 8 warps, 12 warps past 8192
# columns)
_FWD_WARPS = {64: 1, 1000: 4, 1024: 4, 2048: 8, 8192: 8, 16384: 12}
# ... and at more rows than 8 an SM (two vectors a thread)
_FWD_WARPS_MANY = {64: 1, 1000: 2, 1024: 2, 2048: 4, 8192: 8, 16384: 12}


def _covered(plan, rows):
    """How often the kernel's walk (blocks of `rows_per_block` rows, each
    row group taking every `groups`-th row of its block's run) reaches
    each row."""
    groups = _groups(plan)
    seen = np.zeros(rows, np.int64)
    for b in range(plan.blocks):
        r0 = b * plan.rows_per_block
        end = min(r0 + plan.rows_per_block, rows)
        assert end > r0
        for g in range(groups):
            seen[r0 + g:end:groups] += 1
    return seen


@pytest.mark.parametrize("rows,hidden,itemsize,align", [
    (64, 1024, 2, 16), (128, 1024, 2, 16), (5, 1000, 4, 16),
    (12288, 1024, 2, 16), (16384, 1024, 2, 16), (3584, 2048, 2, 16),
    (12288, 64, 2, 16), (12288, 64, 4, 16), (77, 8192, 2, 16),
    (4096, 8192, 2, 16), (1, 16384, 2, 16), (300, 16384, 2, 16),
    (300, 16384, 4, 16), (0, 1024, 2, 16), (1057, 1024, 2, 16),
    (77, 1001, 2, 16), (77, 1000, 4, 4), (12288, 1024, 2, 4),
    (12288, 1024, 2, 2), (9, 1024, 2, 2), (64, 1000, 2, 4)])
def test_fwd_plan(rows, hidden, itemsize, align):
    """`fwd_plan` covers every row exactly once; a row's threads hold
    two 16-byte vectors (one for few rows, at most 8 an SM) where up to 8
    warps hold a 16-byte row so, else at most 32 columns (48 on the 12
    warps of a row past 8192 columns), on the fewest warps that do.  Up to 8192 columns: a block as many row
    groups (up to 8 warps) as spread the rows over the SMs (one at
    decode's 64 rows, two at the training steps' rows), each group a run
    of rows over one wave of the blocks an SM that the kernel's form is
    compiled for (four at decode's rows, two at the training steps'), no
    ring.  Past them: a 12-warp row a block, a block an SM at most, and a
    ring of bulk copies only where the rows' bytes and bases are 16-byte
    multiples, holding as many rows (up to 8) as its 200 KB allow beside
    w's and b's fp32 rows, within the 227 KB a block may take.  Others
    read 4 or 2 bytes at a time, straight from device memory."""
    plan = tln.fwd_plan(rows, hidden, itemsize, _H100_SMS, align)
    wpr = plan.warps_per_row
    wide = align % 16 == 0 and hidden * itemsize % 16 == 0
    few = rows <= _H100_SMS * tln.FWD_WARPS
    if wide and itemsize == 2:
        assert wpr == (_FWD_WARPS if few else _FWD_WARPS_MANY).get(hidden,
                                                                   wpr)
    wide_rows = wpr == tln.FWD_WIDE_WARPS
    # columns a thread holds at most: one 16-byte vector (few rows) or
    # FWD_VECS where 8 warps hold the row so, else up to FWD_COLS
    vcols = (1 if few else tln.FWD_VECS) * 16 // itemsize
    cols = vcols if wide and hidden <= (
        tln.FWD_WARPS * 32 * vcols) else tln.FWD_COLS
    if wide_rows:
        assert hidden > tln.FWD_WARPS * 32 * tln.FWD_COLS
        assert plan.warps == wpr
    else:
        assert hidden <= wpr * 32 * tln.FWD_COLS
        assert wpr == tln.FWD_WARPS or hidden <= wpr * 32 * cols
        assert wpr == 1 or hidden > wpr // 2 * 32 * cols
        assert plan.warps % wpr == 0 and plan.warps <= tln.FWD_WARPS
    assert (plan.load_width == 16) == wide
    if not wide:
        assert plan.load_width in (4, 2) and plan.stages == 0
        assert plan.load_width == 2 or (hidden * itemsize % 4 == 0
                                        and align % 4 == 0)
    if rows == 0:
        assert plan.blocks == 0
        return
    assert np.all(_covered(plan, rows) == 1)
    groups = _groups(plan)
    if not wide_rows:
        assert plan.stages == 0 and plan.rows_per_block % groups == 0
        assert groups == min(tln.FWD_WARPS // wpr, -(-rows // _H100_SMS))
        per_sm = tln.fwd_blocks_per_sm(hidden, itemsize, wpr,
                                       plan.load_width)
        assert plan.blocks <= _H100_SMS * per_sm or (
            plan.rows_per_block == groups)
    else:
        assert plan.blocks <= _H100_SMS and groups == 1
        assert (plan.stages >= 1) == wide
    if plan.stages:
        row_bytes = -(-hidden * itemsize // 16) * 16
        wb = 2 * -(-hidden // 8) * 32
        ring = plan.stages * row_bytes
        assert 1 <= plan.stages <= tln.FWD_MAX_STAGES
        assert ring + wb <= tln.FWD_SMEM < 227 * 1024
        assert (plan.stages == tln.FWD_MAX_STAGES
                or ring + wb + row_bytes > tln.FWD_SMEM)
    if (rows, hidden, itemsize, align) == (64, 1024, 2, 16):
        assert plan == tln.FwdPlan(64, 1, 4, 4, 0, 16)
    if (rows, hidden, itemsize, align) == (12288, 1024, 2, 16):
        assert plan == tln.FwdPlan(256, 48, 8, 2, 0, 16)


@pytest.mark.parametrize("hidden,itemsize,wpr,width,per_sm", [
    (1024, 2, 4, 16, 4), (1024, 2, 2, 16, 2), (2048, 2, 4, 16, 2),
    (1024, 4, 8, 16, 4), (1024, 4, 4, 16, 2), (8192, 2, 8, 16, 1),
    (8192, 4, 8, 16, 1), (16384, 2, 12, 16, 1), (1024, 2, 2, 4, 1),
    (1001, 2, 4, 2, 1)])
def test_fwd_blocks_per_sm(hidden, itemsize, wpr, width, per_sm):
    """The blocks an SM the plan sizes its runs by are those the form
    it launches is compiled for: 4 at one 16-byte vector a thread, 2 at
    two, 1 for the four- and eight-vector forms, the 12-warp rows and
    the narrow rows."""
    assert tln.fwd_blocks_per_sm(hidden, itemsize, wpr, width) == per_sm


def test_fwd_blocks_per_sm_mirrors_the_kernel():
    """`FWD_BLOCKS_PER_SM` is what csrc/layer_norm.cu's `FwdMinBlocks`
    gives `__launch_bounds__` for the 16-byte rows' forms."""
    import os
    import re
    src = os.path.join(os.path.dirname(tln.__file__), os.pardir, "csrc",
                       "layer_norm.cu")
    with open(src) as f:
        text = f.read()
    body = re.search(r"struct FwdMinBlocks \{(.*?)\};", text,
                     re.S).group(1)
    pairs = {int(v): int(n) for v, n in
             re.findall(r"VECS == (\d+)\s*\? (\d+)", body)}
    assert pairs == tln.FWD_BLOCKS_PER_SM
    assert "FwdMinBlocks<THREADS, FAST, VECS>::value)" in text


@pytest.mark.parametrize("hidden", [0, 16385])
def test_fwd_plan_refuses_what_the_kernel_cannot_hold(hidden):
    with pytest.raises(ValueError, match="hidden"):
        tln.fwd_plan(8, hidden, 2, _H100_SMS)


def _fwd_stand_in(monkeypatch, calls):
    """A stand-in for the forward's C launch (`_launch_fwd`): it records
    the plan and fills y, mean and rstd with the plain forward."""
    def launch(plan, x2, weight, bias, y, mean, rstd, eps, rms):
        calls.append(plan)
        assert y.shape == x2.shape and y.dtype == x2.dtype
        assert mean.shape == rstd.shape == (x2.shape[0], 1)
        assert mean.dtype == rstd.dtype == torch.float32
        ry, rmean, rstd_ = tln.norm_fwd_reference(x2, weight, bias, eps, rms)
        y.copy_(ry)
        mean.copy_(rmean)
        rstd.copy_(rstd_)

    monkeypatch.setattr(tln, "_launch_fwd", launch)
    monkeypatch.setattr(tln, "_sm_count", lambda device: _H100_SMS)
    monkeypatch.setattr(tln, "check_kernel_device", lambda *t: True)


@pytest.mark.parametrize("rows,hidden", [(37, 256), (64, 1000)])
@pytest.mark.parametrize("affine", ["both", "weight", "none"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rms", [False, True])
def test_fwd_launcher_matches_jax_fwd_pallas(rms, dtype, affine, rows,
                                             hidden, monkeypatch):
    """`norm_fwd_cuda` with a recording stand-in for its C launch (on the
    CPU): one launch under `fwd_plan`, and its outputs (y in x's dtype,
    fp32 (rows, 1) mean and rstd) match the JAX package's `_fwd_pallas`
    (its Pallas forward in interpret mode) on the same inputs.
    Tolerances: fp32 y atol 1e-5; bf16 y one ulp plus 1e-5 of the
    largest |y|; mean and rstd rtol 1e-5 (fp32 sums in another order)."""
    from apex_tpu.ops.layer_norm import _fwd_pallas

    calls = []
    _fwd_stand_in(monkeypatch, calls)
    x, w, b = _inputs(rows, hidden, seed=rows + hidden)
    jdt, tdt = _DTYPES[dtype]
    tx, tw, tb = (torch.tensor(a).to(tdt) for a in (x, w, b))
    tw = None if affine == "none" else tw
    tb = tb if affine == "both" and not rms else None
    y, mean, rstd = tln.norm_fwd_cuda(tx, tw, tb, 1e-5, rms)
    assert calls == [tln.fwd_plan(rows, hidden, tx.element_size(),
                                  _H100_SMS)]
    assert y.dtype == tdt and mean.shape == rstd.shape == (rows, 1)
    jw = None if tw is None else jnp.asarray(w).astype(jdt)
    jb = None if tb is None else jnp.asarray(b).astype(jdt)
    wy, wmean, wrstd = _fwd_pallas(jnp.asarray(x).astype(jdt), jw, jb, 1e-5,
                                   rms)
    if dtype == "bf16":
        _ulp_close(y, wy, 1e-5 * float(jnp.max(jnp.abs(
            wy.astype(jnp.float32)))))
    else:
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-5,
                                   rtol=0)
    np.testing.assert_allclose(mean.numpy(), np.asarray(wmean).reshape(
        rows, 1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(wrstd).reshape(
        rows, 1), rtol=1e-5, atol=0)


def test_fwd_launcher_checks_before_launching(monkeypatch):
    """Zero rows launch nothing; what the kernel does not take raises
    before any launch: a hidden dim that is not contiguous, another
    dtype, a weight of another width."""
    calls = []
    _fwd_stand_in(monkeypatch, calls)
    y, mean, rstd = tln.norm_fwd_cuda(torch.zeros((0, 64)), None, None,
                                      1e-5, False)
    assert calls == [] and y.shape == (0, 64) and mean.shape == (0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tln.norm_fwd_cuda(torch.zeros((64, 8)).t(), None, None, 1e-5, False)
    with pytest.raises(TypeError, match="fp32/bf16/fp16"):
        tln.norm_fwd_cuda(torch.zeros((4, 8), dtype=torch.float64), None,
                          None, 1e-5, False)
    with pytest.raises(ValueError, match="weight"):
        tln.norm_fwd_cuda(torch.zeros((4, 8)), torch.ones(7), None, 1e-5,
                          False)
    assert calls == []


@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_norm_routes_its_forward_to_the_cuda_launcher(kind, monkeypatch):
    """A CUDA call's forward, with the stand-in for the C launch (on the
    CPU): one launch a call with and without a gradient (the autograd
    route and the inference route), and y matches the JAX package's norm
    with its Pallas forward in interpret mode (fp32, atol 1e-5)."""
    calls = []
    _fwd_stand_in(monkeypatch, calls)
    x, w, b = _inputs(3 * 17, 128, seed=15)
    tx, tw, tb = (torch.tensor(a) for a in (x, w, b))
    jx, jw, jb = (jnp.asarray(a) for a in (x, w, b))
    x3 = tx.reshape(3, 17, 128)
    if kind == "layer":
        want = jax_layer_norm(jx, jw, jb, use_pallas_override=True)
        got = [tln.fused_layer_norm(x3, tw, tb),
               tln.fused_layer_norm(x3, tw.requires_grad_(True), tb)]
    else:
        want = jax_rms_norm(jx, jw, use_pallas_override=True)
        got = [tln.fused_rms_norm(x3, tw),
               tln.fused_rms_norm(x3, tw.requires_grad_(True))]
    assert len(calls) == 2
    for y in got:
        assert y.shape == (3, 17, 128)
        np.testing.assert_allclose(y.detach().numpy().reshape(51, 128),
                                   np.asarray(want), atol=1e-5, rtol=0)
