"""The PyTorch port's ResNet training path (apex_tpu_torch.models.resnet,
ops.pooling, amp O0/O1, FusedSGD, parallel.ddp.make_train_step) against
the JAX package's, on the CPU.

The same seeded numpy inputs go to both; the port's weights are the JAX
model's through `params_from_jax` (conv weights HWIO → OHWI), and every
comparison of weights runs leaf by leaf through that transform.

Tolerances.  The layer tests are fp32: 1e-5 of each output's largest
magnitude (both packages compute the same formulas, with fp32 sums in
another order); the pool's forward exactly.  The train steps: see
`_STEP_TOL`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from apex_tpu import amp as jax_amp
from apex_tpu.models import resnet as jres
from apex_tpu.ops import pooling as jpool
from apex_tpu.ops.xentropy import softmax_cross_entropy_loss as jax_xent
from apex_tpu.optimizers.fused_sgd import FusedSGD as JaxFusedSGD
from apex_tpu.parallel import ddp as jax_ddp
from apex_tpu.parallel import mesh as M
from apex_tpu_torch import amp
from apex_tpu_torch.models import resnet
from apex_tpu_torch.ops import pooling
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.parallel import ddp


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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_port_layout(a):
    a = np.asarray(a, np.float32)
    return a.transpose(3, 0, 1, 2) if a.ndim == 4 else a


def _assert_leaves_close(got_tree, want_tree, rtol, what):
    """Leaf by leaf, the JAX leaf through the HWIO → OHWI transform;
    tolerance `rtol` of the leaf's largest magnitude."""
    got = F.tree_leaves(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want), what
    for (path, g), w in zip(F.tree_leaves_with_paths(got_tree), want):
        w = _to_port_layout(w)
        np.testing.assert_allclose(
            g.detach().float().numpy(), w, rtol=0,
            atol=rtol * max(np.abs(w).max(), 1e-30),
            err_msg=f"{what} {'/'.join(map(str, path))}")


def _conv_case(seed, h, w, cin, cout, k):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, h, w, cin).astype(np.float32)
    wt = rng.randn(k, k, cin, cout).astype(np.float32)
    return x, wt


@pytest.mark.parametrize("h,k,stride,pads", [
    (224, 7, 2, (2, 3)),      # the ImageNet stem
    (56, 3, 2, (0, 1)),       # a 3x3/s2 conv at an even size
    (7, 3, 2, (1, 1)),        # odd size: symmetric
    (14, 1, 2, (0, 0)),       # the 1x1/s2 downsample
    (9, 3, 1, (1, 1)),
])
def test_conv2d_same_padding_matches_lax(h, k, stride, pads):
    """SAME padding is JAX's (total // 2 low, the rest high); the pads
    listed are what `_same_pads` gives and what the conv must see."""
    assert pooling._same_pads(h, k, stride) == pads
    cin = 3 if k == 7 else 4
    x, wt = _conv_case(0, h, h, cin, 5, k)
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wt), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = resnet.conv2d(torch.tensor(x), torch.tensor(_to_port_layout(wt)),
                        stride=stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_symmetric_padding_would_shift_the_windows():
    """Torchvision's symmetric padding=1 on a 3x3/s2 conv at an even size
    computes another function than JAX's SAME: the guard that the test
    above can tell the two apart."""
    x, wt = _conv_case(1, 8, 8, 4, 5, 3)
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wt), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    sym = torch.nn.functional.conv2d(
        torch.tensor(x).permute(0, 3, 1, 2),
        torch.tensor(wt).permute(3, 2, 0, 1), stride=2, padding=1)
    assert not np.allclose(sym.permute(0, 2, 3, 1).numpy(), want, atol=1e-3)


def _tied_pool_input(seed, h):
    """ReLU-like input: half the entries exactly 0, the rest repeated
    values, so windows hold ties."""
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randint(-2, 3, (2, h, h, 3)), 0).astype(np.float32)
    return x


@pytest.mark.parametrize("h,padding", [(8, "SAME"), (7, "SAME"),
                                       (8, "VALID")])
def test_max_pool_forward_and_tied_gradient_match_jax(h, padding):
    """The 3x3/s2 pool on tied inputs: forward and gradient equal the JAX
    package's reduce_window pool and its AD (ties to the first maximum
    in row-major order)."""
    x = _tied_pool_input(h, h)
    rng = np.random.RandomState(7)

    def jf(a):
        return jpool.max_pool2d(a, (3, 3), (2, 2), padding)

    want, vjp = jax.vjp(jf, jnp.asarray(x))
    dy = rng.randn(*want.shape).astype(np.float32)
    (want_dx,) = vjp(jnp.asarray(dy))
    xt = torch.tensor(x, requires_grad=True)
    got = pooling.max_pool2d(xt, (3, 3), (2, 2), padding)
    got.backward(torch.tensor(dy))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=0, atol=1e-6)


def test_max_pool_refuses_the_routed_backward():
    with pytest.raises(NotImplementedError, match="routed_backward"):
        pooling.max_pool2d(torch.zeros(1, 4, 4, 1), routed_backward=True)


def test_relu_gradient_at_the_tie_is_half():
    """jnp.maximum(x, 0) sends half the gradient at x == 0; the port's
    relu must too (F.relu sends none)."""
    x = np.array([-1.0, 0.0, 0.0, 2.0], np.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.maximum(a, 0.0) * 3.0))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (resnet.relu(xt) * 3.0).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    assert xt.grad[1] == 1.5
    xr = torch.tensor(x, requires_grad=True)
    (torch.nn.functional.relu(xr) * 3.0).sum().backward()
    assert not torch.equal(xr.grad, xt.grad)


def test_space_to_depth_stem_equals_conv7():
    """The 2x2 space-to-depth stem (4x4/s1 conv, `_stem_s2d_weights`)
    computes the 7x7/s2 stem's function, in the port and as the JAX
    package's rewrite does."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    w7 = rng.randn(7, 7, 3, 8).astype(np.float32)
    xt, w7t = torch.tensor(x), torch.tensor(_to_port_layout(w7))
    direct = resnet.conv2d(xt, w7t, stride=2)
    s2d = resnet.conv2d(resnet.space_to_depth_2x2(xt),
                        resnet._stem_s2d_weights(w7t), stride=1)
    np.testing.assert_allclose(s2d.numpy(), direct.numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(
        resnet._stem_s2d_weights(w7t).numpy(),
        _to_port_layout(np.asarray(jres._stem_s2d_weights(jnp.asarray(w7)))))
    np.testing.assert_array_equal(
        resnet.space_to_depth_2x2(xt).numpy(),
        np.asarray(jres.space_to_depth_2x2(jnp.asarray(x))))
    model = resnet.ResNet("resnet10", num_classes=10, stem="space_to_depth")
    params, state = model.init(seed=0, device="cpu")
    xb = torch.tensor(rng.randn(2, 64, 64, 3).astype(np.float32))
    a, _ = model.apply(params, state, xb)
    b, _ = resnet.ResNet("resnet10", num_classes=10).apply(params, state, xb)
    assert a.shape == (2, 10)
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               rtol=0, atol=1e-5 * b.abs().max().item())


def test_bottleneck_stride2_downsample_matches_jax():
    """A stride-2 Bottleneck with its downsample branch, in training mode:
    output, new running statistics and every parameter's gradient against
    jax.vjp of the JAX block, fp32."""
    blk_j = jres.Bottleneck(16, 8, stride=2, downsample=True)
    jp, js = blk_j.init(jax.random.PRNGKey(4))
    # a nonzero bn3 scale, so the residual branch carries a gradient
    jp["bn3"]["scale"] = jnp.linspace(0.5, 1.5, 32)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)

    def jf(p, a):
        return blk_j.apply(p, js, a, True, None)

    (jy, jstate), vjp = jax.vjp(jf, jp, jnp.asarray(x))
    dy = rng.randn(*jy.shape).astype(np.float32)
    jgp, jgx = vjp((jnp.asarray(dy), jax.tree_util.tree_map(jnp.zeros_like,
                                                            jstate)))
    blk = resnet.Bottleneck(16, 8, stride=2, downsample=True)
    params, state = resnet.params_from_jax(_np(jp), _np(js), device="cpu")
    leaves = F.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    y, new_state = blk.apply(params, state, xt, True)
    y.backward(torch.tensor(dy))
    assert tuple(y.shape) == (2, 4, 4, 32)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=0, atol=1e-5 * np.abs(jy).max())
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-5 * np.abs(jgx).max())
    grads = F.tree_from_leaves(F.make_spec(params),
                               [t.grad for t in leaves])
    _assert_leaves_close(grads, jgp, 1e-5, "grad")
    _assert_leaves_close(new_state, jstate, 1e-5, "running stats")


def test_params_from_jax_resnet50_layout():
    """ResNet-50's trees through the converter: 161 parameter leaves in
    the JAX package's order, 25,557,032 parameters, 53 batch norms with
    106 running-stat leaves, conv weights OHWI; the port's own init has
    the same structure."""
    jmodel = jres.ResNet("resnet50")
    jp, js = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                    (jp, js))
    params, state = resnet.params_from_jax(*shapes, device="cpu")
    spec = F.make_spec(params)
    assert len(spec.sizes) == 161 and sum(spec.sizes) == 25_557_032
    assert len(F.tree_leaves(state)) == 106
    assert -(-spec.total // 65536) * 65536 == 25_559_040
    assert tuple(params["conv_stem"].shape) == (64, 7, 7, 3)
    assert tuple(params["block3"]["conv2"].shape) == (128, 3, 3, 128)
    assert tuple(params["fc_w"].shape) == (2048, 1000)
    want = [tuple(np.shape(_to_port_layout(a)))
            for a in jax.tree_util.tree_leaves(shapes[0])]
    assert list(spec.shapes) == want
    own, own_state = resnet.resnet50().init(seed=0, device="cpu")
    assert F.make_spec(own).shapes == spec.shapes
    assert F.make_spec(own).paths == spec.paths
    assert F.make_spec(own_state).paths == F.make_spec(state).paths
    assert float(own["block0"]["bn3"]["scale"].abs().sum()) == 0.0


# ---------------------------------------------------------------- the step

def _jax_step(model, opt_level, mesh):
    amp_state = jax_amp.initialize(opt_level=opt_level)

    def loss_fn(p, ms, b):
        x, y = b
        logits, new_ms = model.apply(p, ms, x, training=True)
        return jnp.mean(jax_xent(logits.astype(jnp.float32), y)), new_ms

    opt = JaxFusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
    step = jax_ddp.make_train_step(loss_fn, opt, mesh, amp_state=amp_state,
                                   batch_spec=(P("dp"), P("dp")),
                                   with_state=True, donate=False)
    return opt, step, amp_state.loss_scalers[0]


def _port_step(model, opt_level):
    amp_state = amp.initialize(opt_level=opt_level, device="cpu")

    def loss_fn(p, ms, b):
        x, y = b
        logits, new_ms = model.apply(p, ms, x, training=True)
        return torch.mean(softmax_cross_entropy_loss(logits.float(), y)), \
            new_ms

    opt = FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
    step = ddp.make_train_step(loss_fn, opt, amp_state=amp_state,
                               with_state=True, device="cpu")
    return opt, step, amp_state.loss_scalers[0]


def _jax_flat_in_port_layout(jopt, jflat):
    from apex_tpu.optimizers import flat as jflat_mod
    tree = jflat_mod.unflatten(jflat, jopt.spec)
    return np.concatenate([_to_port_layout(w).ravel()
                           for w in jax.tree_util.tree_leaves(tree)])


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# (loss rtol, relative L2 of the param update, of the momentum buffer,
# of the running statistics), per step.  O0: fp32 in both packages; the
# first step's sums differ in order only (~2e-6 measured), and three
# steps at lr 0.1 on fresh random labels amplify that ~10x a step
# (4e-4 after three).  O1: bf16 compute; XLA's CPU backend keeps
# excess precision inside fusions where torch rounds each op to bf16,
# and the per-channel sums of bf16 gradients that make the batch-norm
# grads cancel to a few % of their terms, so each package's O1 grads sit
# ~20 % (relative L2, batch-norm biases) from the fp32 grads and the two
# packages' updates ~10 % apart (measured 6-11 %); a step computing
# another function (no momentum, no weight decay, another loss scale)
# moves them by O(1).
_STEP_TOL = {"O0": (1e-5, 2e-3, 2e-3, 1e-5),
             "O1": (2e-3, 0.3, 0.4, 5e-3)}


@pytest.mark.parametrize("opt_level", ["O0", "O1"])
def test_three_train_steps_match_jax(opt_level):
    """Three steps of the bench's CPU ResNet shape (`bench.py:353-354`:
    resnet18, batch 4, 32x32, conv7 stem, axis "dp" on a one-device mesh)
    with FusedSGD(0.1, 0.9, 1e-4) through both packages'
    `make_train_step(with_state=True)`, a new seeded batch each step:
    after every step the loss, the param update, the momentum buffer and
    the running statistics (tolerances in `_STEP_TOL`); the scaler state
    and step count exactly; under O0 each leaf's first-step gradient
    within 1e-4 relative L2; the grads reach the optimizer in the
    compute dtype."""
    M.destroy_model_parallel()
    mesh = M.initialize_model_parallel(devices=jax.devices()[:1])
    jmodel = jres.ResNet("resnet18", num_classes=1000, axis_name="dp")
    jparams, jms = jmodel.init(jax.random.PRNGKey(0))
    model = resnet.ResNet("resnet18", num_classes=1000)
    params, ms = resnet.params_from_jax(_np(jparams), _np(jms), device="cpu")
    jopt, jstep, jsc = _jax_step(jmodel, opt_level, mesh)
    jstate = jopt.init(jparams)
    opt, step, sc = _port_step(model, opt_level)
    state = opt.init(params)
    seen = []
    step_flat = opt.step_flat

    def capture(st, g_flat, **kw):
        seen.append(g_flat.dtype)
        return step_flat(st, g_flat, **kw)

    opt.step_flat = capture
    n = sum(opt.spec.sizes)
    p0 = state.params[:n].clone().numpy()
    loss_rtol, upd_tol, buf_tol, stat_tol = _STEP_TOL[opt_level]
    for i in range(3):
        rng = np.random.RandomState(10 + i)
        x = rng.randn(4, 32, 32, 3).astype(np.float32)
        y = rng.randint(0, 1000, (4,)).astype(np.int32)
        jstate, jsc, jms, jloss = jstep(jstate, jsc, jms,
                                        (jnp.asarray(x), jnp.asarray(y)))
        state, sc, ms, loss = step(state, sc, ms,
                                   (torch.tensor(x), torch.tensor(y)))
        assert loss.ndim == 0 and loss.dtype == torch.float32
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=loss_rtol)
        upd = state.params[:n].numpy() - p0
        assert _rel_l2(upd, _jax_flat_in_port_layout(jopt, jstate.params)
                       - p0) <= upd_tol, f"param update, step {i}"
        jbuf = _jax_flat_in_port_layout(jopt, jstate.momentum_buffer)
        assert _rel_l2(state.momentum_buffer[:n].numpy(), jbuf) \
            <= buf_tol, f"momentum buffer, step {i}"
        stats = np.concatenate([t.numpy().ravel() for t in F.tree_leaves(ms)])
        jstats = np.concatenate([np.asarray(t).ravel()
                                 for t in jax.tree_util.tree_leaves(jms)])
        assert _rel_l2(stats, jstats) <= stat_tol, f"running stats, step {i}"
        if i == 0 and opt_level == "O0":
            # the first momentum buffer is g + wd * p, leaf by leaf
            for path, off, size in zip(opt.spec.paths, opt.spec.offsets,
                                       opt.spec.sizes):
                got = state.momentum_buffer[off:off + size].numpy()
                assert _rel_l2(got, jbuf[off:off + size]) <= 1e-4, path
    want_dtype = torch.float32 if opt_level == "O0" else torch.bfloat16
    assert seen == [want_dtype] * 3
    assert int(state.step) == int(jstate.step) == 3
    assert float(sc.scale) == float(jsc.scale)
    assert int(sc.growth_tracker) == int(jsc.growth_tracker) == (
        3 if opt_level == "O1" else 0)      # O0: a static scale
    assert bool(sc.found_inf) is bool(jsc.found_inf) is False
    M.destroy_model_parallel()


def test_what_the_step_refuses():
    """Accumulation, fp32 main grads and the monitor planes come with
    later ROADMAP items; the entry points run on the card unless asked
    for the CPU."""
    opt = FusedSGD(lr=0.1)
    for kw in ({"num_microbatches": 2}, {"main_grad_dtype": torch.float32},
               {"metrics": True}, {"trace": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ddp.make_train_step(lambda p, b: 0.0, opt, device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ddp.make_train_step(lambda p, b: 0.0, opt)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resnet.resnet18().init()
