"""The PyTorch port's fused dense and MLP (apex_tpu_torch.ops.fused_dense,
ops.mlp and the package-root facades) against the JAX package's, on the
CPU.

The JAX side runs its Pallas matmul kernel in interpret mode
(`use_pallas_override=True`) with its custom_vjp backward; the port's
side runs its plain PyTorch version (what CPU tensors get) under
autograd, and, for the CUDA route's autograd function, that function
with a counting stand-in for the kernel's launcher.  Weights are in one
layout in both packages, (in, out), and carried by `params_from_jax`.
The same seeded numpy inputs go to both.

Tolerances.  fp32: outputs and grads rtol 1e-5 / atol 1e-5 of each
tensor's largest magnitude (fp32 sums in another order).  bf16 and
fp16: outputs within one ulp of the dtype at each value plus 1e-6 (the
fp32 results may round to neighbouring values); grads within 1e-2 of
each tensor's largest magnitude (the JAX backward rounds the cotangent
to the input dtype before its products, autograd through the plain
version does not)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import fused_dense as jfd
from apex_tpu.ops.mlp import MLP as JaxMLP
from apex_tpu_torch import fused_dense as facade
from apex_tpu_torch.mlp import MLP
from apex_tpu_torch.normalization import FusedLayerNorm, MixedFusedLayerNorm
from apex_tpu_torch.ops import fused_dense as fdn
from apex_tpu_torch.ops.fused_dense import (FusedDense, FusedDenseGeluDense,
                                            linear_bias, params_from_jax)

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16),
           "f16": (jnp.float16, torch.float16)}
_ACTS = [None, "relu", "gelu", "sigmoid"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's plain versions on one CPU thread.  Once JAX has run
    in the process, torch's vector math (sqrt, exp, tanh) on an intra-op
    worker thread sometimes comes out at ~3e-4 relative error, in about
    one process in ten; the main thread always computes it in full."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_out(got, want, dtype):
    got, want = got.detach().float().numpy(), _np(want)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        _, e = np.frexp(np.abs(want))
        bits = 8 if dtype == "bf16" else 11
        assert np.all(np.abs(got - want)
                      <= np.ldexp(np.ones_like(want), e - bits) + 1e-6)


def _close_grad(got, want, dtype):
    got, want = got.detach().float().numpy(), _np(want)
    tol = 1e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(got, want, rtol=0 if dtype != "f32" else 1e-5,
                               atol=tol * np.abs(want).max())


def _inputs(rng, m, k, n, dtype, bias):
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    b = rng.randn(n).astype(np.float32) if bias else None
    ct = rng.randn(m, n).astype(np.float32)
    jdt, tdt = _DTYPES[dtype]
    jx = [None if a is None else jnp.asarray(a).astype(jdt)
          for a in (x, w, b)]
    tx = [None if a is None else torch.tensor(a).to(tdt).requires_grad_(True)
          for a in (x, w, b)]
    return jx, tx, ct


def _jax_value_and_grads(jx, ct, act):
    """The JAX function's output without a gradient (the activation fused
    into the kernel), its output under jax.grad (the custom_vjp forward
    rounds the pre-activation to the input dtype before the activation),
    and the grads of sum(y · ct)."""
    jdt = jx[0].dtype
    has_b = jx[2] is not None

    def loss(x, w, b):
        y = jfd.linear_bias(x, w, b if has_b else None, act,
                            use_pallas_override=True)
        return jnp.sum(y.astype(jnp.float32) * ct), y

    y = jax.jit(lambda x, w, b: jfd.linear_bias(
        x, w, b, act, use_pallas_override=True))(*jx)
    (_, y_vjp), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jx[0], jx[1], jx[2] if has_b else jnp.zeros((), jdt))
    return y, y_vjp, grads


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("act", _ACTS)
def test_linear_bias_matches_jax(act, dtype, bias):
    """A ragged shape (x (2, 5, 27) · w (27, 13)): the output and the
    grads of x, w and b for sum(y · ct) against jax.grad of the JAX
    function (its Pallas kernel and custom_vjp)."""
    rng = np.random.RandomState(21)
    jx, tx, ct = _inputs(rng, 10, 27, 13, dtype, bias)
    jy, _, jgrads = _jax_value_and_grads(jx, ct, act)
    x3 = tx[0].reshape(2, 5, 27)
    y = linear_bias(x3, tx[1], tx[2], act)
    assert y.shape == (2, 5, 13) and y.dtype == _DTYPES[dtype][1]
    _close_out(y.reshape(10, 13), jy, dtype)
    (y.reshape(10, 13).float() * torch.tensor(ct)).sum().backward()
    for t, g in zip(tx, jgrads):
        if t is not None:
            assert t.grad.dtype == t.dtype
            _close_grad(t.grad, g, dtype)


@pytest.mark.parametrize("act", _ACTS)
@pytest.mark.parametrize("needs_grad", [True, False])
def test_cuda_route_autograd_matches_jax(act, needs_grad):
    """The CUDA route (`_FusedLinearFn`) with a counting stand-in for the
    kernel's launcher, on the CPU, bf16, N = 1 (apex's MLP's last
    layer): one launch a forward; with a gradient and an activation the
    launch is without it (the pre-activation is kept), else the
    activation is fused; the backward against the JAX custom_vjp's."""
    rng = np.random.RandomState(22)
    jx, tx, ct = _inputs(rng, 9, 16, 1, "bf16", True)
    calls = []

    def stand_in(x2, w, b, activation):
        calls.append(activation)
        return fdn.linear_bias_reference(x2, w, b, activation)

    saved = fdn.linear_bias_cuda
    fdn.linear_bias_cuda = stand_in
    try:
        with torch.set_grad_enabled(needs_grad):
            y = fdn._linear_fused(tx[0], tx[1], tx[2], act)
    finally:
        fdn.linear_bias_cuda = saved
    fused = None if act is None or needs_grad else act
    assert calls == [fused]
    jy, jy_vjp, jgrads = _jax_value_and_grads(jx, ct, act)
    _close_out(y, jy_vjp if needs_grad else jy, "bf16")
    if needs_grad:
        (y.float() * torch.tensor(ct)).sum().backward()
        for t, g in zip(tx, jgrads):
            _close_grad(t.grad, g, "bf16")


@pytest.mark.parametrize("x_off,w_off", [(0, 0), (2, 0), (0, 8), (16, 32)])
@pytest.mark.parametrize("k,n", [(480, 1032), (1032, 480), (70, 1032),
                                 (480, 1), (1024, 70), (0, 8), (27, 3),
                                 (1024, 8), (0, 1), (0, 16)])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
def test_gemm_route(dtype, k, n, x_off, w_off):
    """The kernel by dtype, shape and alignment: n ≤ 8 the GEMV kernel in
    every dtype; else fp32 the FMA kernel, and 16-bit the wgmma + TMA
    kernel exactly where a TMA tensor map can address both operands (k >
    0, k and n multiples of 8, both bases 16-byte aligned), else
    mma.sync."""
    tdt = _DTYPES[dtype][1]
    base = 1 << 20
    got = fdn.gemm_route(tdt, 96, n, k, base + x_off, base + w_off)
    if n <= 8:
        want = "gemv"
    elif dtype == "f32":
        want = "fma"
    elif k > 0 and k % 8 == 0 and n % 8 == 0 and (x_off, w_off) in (
            (0, 0), (16, 32)):
        want = "wgmma"
    else:
        want = "mma"
    assert got == want


# apex's run_mlp layers at batch 1024 (chip_smoke.MLP_LAYERS' fp32 ones),
# (m, k, n), and an H100 SXM's cluster occupancy (the clusters of 1 .. 8
# fp32-kernel blocks it holds at once, as the runtime's query gave them on
# the card, either tile)
_MLP_F32_LAYERS = [(1024, 480, 1024), (1024, 1024, 1024), (1024, 1024, 512),
                   (1024, 512, 256)]
_H100_CLUSTERS = {tile: [132, 66, 39, 30, 22, 17, 15, 15]
                  for tile in fdn.F32_TILES}


@pytest.mark.parametrize("clusters", [None, _H100_CLUSTERS])
@pytest.mark.parametrize("m,k,n,sms", [
    (m, k, n, 132) for m, k, n in _MLP_F32_LAYERS] + [
    (1000, 27, 13, 132), (129, 70, 50, 132), (300, 200, 264, 132),
    (12289, 1032, 520, 132), (12288, 1024, 4096, 132), (1, 5, 30, 132),
    (5, 0, 20, 132), (1, 100000, 9, 132), (1024, 1024, 1024, 114),
    (2048, 1000, 640, 132), (40 * 128, 1024, 128, 132)])
def test_f32_plan(m, k, n, sms, clusters):
    """`f32_plan`: one of the two tiles; a split of 1 to 8 whose blocks'
    depth ranges, whole 16-deep slices, cover [0, k) exactly once with
    none empty; and the card filled where m, n and k allow it: with fewer
    128 x 64 tiles than half the SMs and at least 32 slices of depth (so
    that a split pays for its reduction), more than half the SMs take a
    block, or the split is 8."""
    clusters = clusters if sms == 132 else None
    tile, split, k_split = fdn.f32_plan(m, n, k, sms, clusters)
    assert tile in fdn.F32_TILES
    assert 1 <= split <= 8 and k_split % 16 == 0 and k_split >= 0
    covered = np.zeros(k, dtype=int)
    for r in range(split):
        lo, hi = r * k_split, min(k, (r + 1) * k_split)
        assert hi > lo or k == 0
        covered[lo:hi] += 1
    assert np.all(covered == 1)
    tiles = -(-m // tile[0]) * -(-n // tile[1])
    if 2 * (-(-m // 128) * -(-n // 64)) <= sms and k >= 32 * 16:
        assert 2 * tiles * split > sms or split == 8


@pytest.mark.parametrize("clusters,plans", [
    (None, [((128, 128), 2), ((128, 128), 2), ((128, 128), 4),
            ((128, 64), 4)]),
    (_H100_CLUSTERS, [((128, 128), 2), ((128, 128), 2), ((128, 64), 2),
                      ((128, 64), 3)])])
def test_f32_plan_at_the_mlp_layers(clusters, plans):
    """The MLP layers' plans on 132 SMs: 128 x 128 tiles split 2 at the
    two wide layers (128 blocks); by default (every cluster fits) 128 x
    128 split 4 and 128 x 64 split 4 at the last two; with an H100's
    clusters (30 of 4 blocks and 15 of 8, where 32 and 16 would be
    needed) 128 x 64 split 2 and split 3, each in one wave of clusters
    (the fastest of the tiles and splits the card timed)."""
    for (m, k, n), want in zip(_MLP_F32_LAYERS, plans):
        tile, split, k_split = fdn.f32_plan(m, n, k, 132, clusters)
        assert (tile, split) == want
        tiles = (m // tile[0]) * (n // tile[1])
        held = clusters[tile][split - 1] if clusters else 132 // split
        assert tiles <= held and split * k_split >= k > (split - 1) * k_split


@pytest.mark.parametrize("route,el,k,n,x_off,w_off,want", [
    ("fma", 4, 512, 256, 0, 0, True), ("fma", 4, 27, 16, 0, 0, False),
    ("fma", 4, 512, 13, 0, 0, False), ("fma", 4, 512, 256, 4, 0, False),
    ("fma", 4, 512, 256, 0, 8, False), ("gemv", 4, 256, 1, 0, 0, True),
    ("gemv", 2, 256, 1, 0, 0, True), ("gemv", 2, 1004, 1, 0, 0, False),
    ("gemv", 4, 27, 1, 0, 0, False), ("gemv", 2, 256, 3, 2, 0, False),
    ("gemv", 2, 256, 3, 0, 2, True), ("mma", 2, 70, 16, 0, 0, False)])
def test_vec_loads(route, el, k, n, x_off, w_off, want):
    """The load width the host picks before the launch: 16 bytes a thread
    for the fp32 kernel where k and n are multiples of 4 and x and w
    16-byte aligned, for the GEMV kernel where every row of x starts
    16-byte aligned (w is staged element by element either way)."""
    base = 1 << 20
    assert fdn.vec_loads(route, el, k, n, base + x_off, base + w_off) is want


def test_plan_of_each_route(monkeypatch):
    """`_plan`, what `_launch` hands the C entry besides the operands: the
    fp32 route `f32_plan` on the card's SMs and clusters (here an H100's)
    and its load width, the GEMV and 16-bit routes one block's depth."""
    monkeypatch.setattr(fdn, "_sm_count", lambda device: 132)
    monkeypatch.setattr(fdn, "f32_clusters", lambda device: _H100_CLUSTERS)
    fdn._f32_plan_on.cache_clear()
    x = torch.zeros(1024, 512)
    w = torch.zeros(512, 256)
    assert fdn._plan("fma", x, w) == (64, 3, 176, True)
    assert fdn._plan("fma", x[:, 1:], torch.zeros(511, 256)) == (
        64, 3, 176, False)
    xb = torch.zeros(1024, 256, dtype=torch.bfloat16)
    wb = torch.zeros(256, 1, dtype=torch.bfloat16)
    assert fdn._plan("gemv", xb, wb) == (0, 1, 256, True)
    assert fdn._plan("gemv", torch.zeros(9, 27), torch.zeros(27, 1)) == (
        0, 1, 27, False)


def test_gemm_route_refuses_other_dtypes():
    with pytest.raises(TypeError, match="fp32/bf16/fp16"):
        fdn.gemm_route(torch.float64, 4, 8, 8, 0, 0)


# (route, dtype, k, n, x misaligned by one element): the routes a CPU
# tensor reaches with the launchers stood in for
_ROUTE_CASES = [("wgmma", "bf16", 16, 16, False),
                ("wgmma", "f16", 48, 24, False),
                ("mma", "bf16", 16, 12, False), ("mma", "f16", 70, 16, False),
                ("mma", "bf16", 16, 16, True), ("fma", "f32", 16, 16, False),
                ("gemv", "f32", 16, 1, False), ("gemv", "bf16", 16, 1, False),
                ("gemv", "f16", 70, 3, False), ("gemv", "bf16", 16, 8, True)]


@pytest.mark.parametrize("needs_grad", [True, False])
@pytest.mark.parametrize("act", [None, "gelu"])
@pytest.mark.parametrize("route,dtype,k,n,misaligned", _ROUTE_CASES)
def test_each_route_through_the_autograd_function(route, dtype, k, n,
                                                  misaligned, act,
                                                  needs_grad, monkeypatch):
    """`_FusedLinearFn` and `linear_bias_cuda` on each route, with a
    recording stand-in for `_launch` (on the CPU): the route is the one
    the shape, dtype and alignment call for, taken once a forward, and the
    output and grads match the JAX `linear_bias` (its Pallas kernel in
    interpret mode and its custom_vjp)."""
    rng = np.random.RandomState(23)
    jx, tx, ct = _inputs(rng, 9, k, n, dtype, True)
    calls = []

    def launch(route, x2, w, b, y, activation):
        calls.append((route, activation))
        assert b is None or b.dtype == torch.float32
        y.copy_(fdn.linear_bias_reference(x2, w, b, activation))

    monkeypatch.setattr(fdn, "_launch", launch)
    x2 = tx[0]
    if misaligned:   # the same values one element into a buffer
        buf = torch.empty(x2.numel() + 8, dtype=x2.dtype)
        x2 = buf[1:1 + x2.numel()].view(x2.shape)
        x2.copy_(tx[0])
        assert x2.data_ptr() % 16 != 0
    with torch.set_grad_enabled(needs_grad):
        y = fdn._linear_fused(x2, tx[1], tx[2], act)
    fused = None if act is None or needs_grad else act
    assert calls == [(route, fused)]
    jy, jy_vjp, jgrads = _jax_value_and_grads(jx, ct, act)
    _close_out(y, jy_vjp if needs_grad else jy, dtype)
    if needs_grad:
        (y.float() * torch.tensor(ct)).sum().backward()
        for t, g in zip(tx, jgrads):
            _close_grad(t.grad, g, dtype)


def test_fused_dense_gelu_dense_and_fused_dense_with_jax_weights():
    """FusedDenseGeluDense and FusedDense with the JAX modules' weights
    (params_from_jax: a plain copy), fp32: forward and the weights'
    grads against the JAX apply (Pallas in interpret mode)."""
    rng = np.random.RandomState(23)
    x = rng.randn(4, 3, 16).astype(np.float32)
    for jmod, tmod in ((jfd.FusedDenseGeluDense(16, 32, 8),
                        FusedDenseGeluDense(16, 32, 8, device="cpu")),
                       (jfd.FusedDense(16, 8), FusedDense(16, 8,
                                                          device="cpu"))):
        jp = jmod.init(jax.random.PRNGKey(6))
        tmod.load_state_dict(params_from_jax(jp))
        ct = rng.randn(4, 3, 8).astype(np.float32)

        def jloss(p):
            y = jmod.apply(p, jnp.asarray(x), use_pallas_override=True)
            return jnp.sum(y * ct), y

        (_, jy), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
        y = tmod(torch.tensor(x))
        _close_out(y, jy, "f32")
        (y * torch.tensor(ct)).sum().backward()
        for name, prm in tmod.named_parameters():
            _close_grad(prm.grad, jg[name], "f32")
    assert facade.FusedDense is FusedDense
    assert MixedFusedLayerNorm is FusedLayerNorm


@pytest.mark.parametrize("activation,bias", [("relu", True),
                                             ("sigmoid", False),
                                             ("none", True)])
def test_mlp_matches_jax(activation, bias):
    """≡ apex's tests/L0/run_mlp: the MLP chain with the JAX MLP's
    weights, fp32, forward and every weight's grad; the last layer has
    one output and no activation."""
    rng = np.random.RandomState(24)
    sizes = [13, 27, 11, 1]
    jmlp = JaxMLP(sizes, bias=bias, activation=activation)
    jp = jmlp.init(jax.random.PRNGKey(7))
    mlp = MLP(sizes, bias=bias, activation=activation, device="cpu")
    mlp.load_state_dict(params_from_jax(jp))
    x = rng.randn(9, 13).astype(np.float32)
    ct = rng.randn(9, 1).astype(np.float32)

    def jloss(p):
        y = jmlp.apply(p, jnp.asarray(x), use_pallas_override=True)
        return jnp.sum(y * ct), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    y = mlp(torch.tensor(x))
    assert y.shape == (9, 1)
    _close_out(y, jy, "f32")
    (y * torch.tensor(ct)).sum().backward()
    for i, w in enumerate(mlp.weights):
        _close_grad(w.grad, jg["weights"][i], "f32")
    for i, b in enumerate(mlp.biases):
        _close_grad(b.grad, jg["biases"][i], "f32")
    assert len(mlp.biases) == (len(sizes) - 1 if bias else 0)


@pytest.mark.parametrize("activation,bias", [("relu", True),
                                             ("sigmoid", False),
                                             ("none", True)])
def test_mlp_routes_through_the_stand_in(activation, bias, monkeypatch):
    """The MLP chain of `test_mlp_matches_jax` on the CUDA route
    (`_FusedLinearFn`, the device check passed), with a recording
    stand-in for `_launch`: one launch a layer, the fp32 FMA kernel for
    the two wide layers and the GEMV kernel for the last (N = 1); the
    output and every weight's grad against the JAX MLP (Pallas in
    interpret mode)."""
    rng = np.random.RandomState(24)
    sizes = [13, 27, 11, 1]
    jmlp = JaxMLP(sizes, bias=bias, activation=activation)
    jp = jmlp.init(jax.random.PRNGKey(7))
    mlp = MLP(sizes, bias=bias, activation=activation, device="cpu")
    mlp.load_state_dict(params_from_jax(jp))
    x = rng.randn(9, 13).astype(np.float32)
    ct = rng.randn(9, 1).astype(np.float32)
    routes = []

    def launch(route, x2, w, b, y, act):
        routes.append(route)
        y.copy_(fdn.linear_bias_reference(x2, w, b, act))

    monkeypatch.setattr(fdn, "_launch", launch)
    monkeypatch.setattr(fdn, "check_kernel_device", lambda *t: True)

    def jloss(p):
        y = jmlp.apply(p, jnp.asarray(x), use_pallas_override=True)
        return jnp.sum(y * ct), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    y = mlp(torch.tensor(x))
    assert routes == ["fma", "fma", "gemv"]
    _close_out(y, jy, "f32")
    (y * torch.tensor(ct)).sum().backward()
    for i, w in enumerate(mlp.weights):
        _close_grad(w.grad, jg["weights"][i], "f32")
    for i, b in enumerate(mlp.biases):
        _close_grad(b.grad, jg["biases"][i], "f32")


def test_wgrad_accum_matches_jax_in_place():
    rng = np.random.RandomState(25)
    x = rng.randn(2, 5, 7).astype(np.float32)
    g = rng.randn(2, 5, 3).astype(np.float32)
    mg = rng.randn(7, 3).astype(np.float32)
    want = jfd.wgrad_accum(jnp.asarray(mg),
                           jnp.asarray(x).astype(jnp.bfloat16),
                           jnp.asarray(g).astype(jnp.bfloat16))
    main = torch.tensor(mg)
    out = fdn.wgrad_accum(main, torch.tensor(x).to(torch.bfloat16),
                          torch.tensor(g).to(torch.bfloat16))
    assert out is main and main.dtype == torch.float32
    np.testing.assert_allclose(main.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_what_the_kernel_route_refuses():
    x, w = torch.ones(3, 4), torch.ones(4, 2)
    with pytest.raises(ValueError, match="unknown activation"):
        linear_bias(x, w, None, "tanh")
    with pytest.raises(ValueError, match="on one card"):
        fdn.linear_bias_cuda(x, w, None, None)
    with pytest.raises(TypeError, match="one dtype"):
        fdn.linear_bias_cuda(x, w.double(), None, None)
    with pytest.raises(ValueError, match=r"x \(M, K\)"):
        fdn.linear_bias_cuda(x, torch.ones(3, 2), None, None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MLP([4, 2])
