"""The port's contrib modules (apex_tpu_torch.contrib) against the JAX
package's (apex_tpu.contrib), on the CPU, from the same seeded numpy
inputs.

  * focal_loss, index_mul_2d (forward and both gradients), the four
    conv_bias_relu forms, TransducerJoint and transducer_loss (and its
    gradient by autograd against `jax.grad`, ragged f_len and y_len),
    BatchNorm2d_NHWC on one rank, create_mask (fp32 and bf16, with ties),
    search_channel_permutation (the same permutation and score, with
    and without the >max_cols subdivision) and ASP.  fp32 tolerances
    1e-5 (both sides sum fp32 terms in other orders); the transducer
    1e-4 relative (a recursion of T * U log-sum-exps).
  * The collectives in ONE 4-rank gloo world (scenario `contrib` of
    tests/torch_dist_worker.py): spatial_conv2d on H-sharded input and
    its gradients (the weight's summed over the ranks) against the dense
    SAME conv's by `jax.grad`, PeerHaloExchanger1d, and
    BatchNorm2d_NHWC over two groups of two ranks (the add-ReLU)
    against the JAX module over a ("dpo", "bn") mesh's "bn" sub-axis in
    `shard_map`.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.contrib import conv_bias_relu as jcbr
from apex_tpu.contrib import groupbn as jgbn
from apex_tpu.contrib import sparsity as jsp
from apex_tpu.contrib import transducer as jtr
from apex_tpu.contrib.focal_loss import focal_loss as jfocal
from apex_tpu.contrib.index_mul_2d import index_mul_2d as jindex_mul
from apex_tpu.models.resnet import conv2d as jconv2d
from apex_tpu_torch.contrib import conv_bias_relu as tcbr
from apex_tpu_torch.contrib import groupbn as tgbn
from apex_tpu_torch.contrib import sparsity as tsp
from apex_tpu_torch.contrib import transducer as ttr
from apex_tpu_torch.contrib.focal_loss import focal_loss as tfocal
from apex_tpu_torch.contrib.index_mul_2d import index_mul_2d as tindex_mul

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

WORLD = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol=1e-5, rtol=0.0, what=""):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got), np.asarray(want, np.float32), atol=atol,
        rtol=rtol, err_msg=what)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_focal_loss_matches_jax(smoothing):
    """(2, 50, 12) logits, 10 real classes, targets with ignore (-2) and
    background (-1) entries."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 50, 12).astype(np.float32)
    t = rng.randint(-2, 10, (2, 50)).astype(np.int32)
    want = jfocal(jnp.asarray(x), jnp.asarray(t), jnp.float32(7.0), 10,
                  label_smoothing=smoothing)
    got = tfocal(torch.tensor(x), torch.tensor(t), 7.0, 10,
                 label_smoothing=smoothing)
    _close(got, want, rtol=1e-5)
    # ignored entries give nothing: changing their logits changes nothing
    x2 = x.copy()
    x2[t == -2] += 5.0
    _close(tfocal(torch.tensor(x2), torch.tensor(t), 7.0, 10,
                  label_smoothing=smoothing), want, rtol=1e-5)


def test_index_mul_2d_matches_jax():
    rng = np.random.RandomState(2)
    in1 = rng.randn(10, 4).astype(np.float32)
    in2 = rng.randn(12, 4).astype(np.float32)
    idx = rng.randint(0, 10, 12).astype(np.int32)
    g = rng.randn(12, 4).astype(np.float32)
    jo, vjp = jax.vjp(lambda a, b: jindex_mul(a, b, jnp.asarray(idx)),
                      jnp.asarray(in1), jnp.asarray(in2))
    jg1, jg2 = vjp(jnp.asarray(g))
    t1, t2 = (torch.tensor(a).requires_grad_(True) for a in (in1, in2))
    out = tindex_mul(t1, t2, torch.tensor(idx))
    out.backward(torch.tensor(g))
    _close(out, jo)
    _close(t1.grad, jg1)
    _close(t2.grad, jg2)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_bias_relu_forms_match_jax(stride):
    rng = np.random.RandomState(3 + stride)
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    w_hwio = rng.randn(3, 3, 3, 4).astype(np.float32) * 0.3
    b, sc = rng.randn(4).astype(np.float32), rng.randn(4).astype(np.float32)
    oh = (8 + stride - 1) // stride
    mask = (rng.rand(2, oh, oh, 4) > 0.3).astype(np.float32)
    jx, jw = jnp.asarray(x), jnp.asarray(w_hwio)
    tx, tw = torch.tensor(x), torch.tensor(w_hwio).permute(3, 0, 1, 2)
    pairs = (
        (jcbr.conv_bias_relu(jx, jw, jnp.asarray(b), stride),
         tcbr.conv_bias_relu(tx, tw, torch.tensor(b), stride)),
        (jcbr.conv_bias(jx, jw, jnp.asarray(b), stride),
         tcbr.conv_bias(tx, tw, torch.tensor(b), stride)),
        (jcbr.conv_bias_mask_relu(jx, jw, jnp.asarray(b), jnp.asarray(mask),
                                  stride),
         tcbr.conv_bias_mask_relu(tx, tw, torch.tensor(b),
                                  torch.tensor(mask), stride)),
        (jcbr.conv_frozen_scale_bias_relu(jx, jw, jnp.asarray(sc),
                                          jnp.asarray(b), stride),
         tcbr.conv_frozen_scale_bias_relu(tx, tw, torch.tensor(sc),
                                          torch.tensor(b), stride)))
    for i, (want, got) in enumerate(pairs):
        _close(got, want, what=f"form {i}")


def test_transducer_joint_matches_jax():
    rng = np.random.RandomState(5)
    f = rng.randn(2, 4, 8).astype(np.float32)
    g = rng.randn(2, 3, 8).astype(np.float32)
    for relu in (False, True):
        _close(ttr.TransducerJoint(relu=relu)(torch.tensor(f),
                                              torch.tensor(g)),
               jtr.TransducerJoint(relu=relu)(jnp.asarray(f),
                                              jnp.asarray(g)))
    with pytest.raises(NotImplementedError):
        ttr.TransducerJoint(pack_output=True)
    with pytest.raises(NotImplementedError):
        ttr.TransducerLoss(packed_input=True)


def test_transducer_loss_and_grad_match_jax():
    """(3, 7, 5, 9) log-probs with ragged f_len (7, 5, 1) and y_len (4,
    2, 0): the per-sample loss and the gradient of a weighted sum with
    respect to the logits."""
    rng = np.random.RandomState(6)
    Bn, T, U, V = 3, 7, 4, 9
    x = rng.randn(Bn, T, U + 1, V).astype(np.float32)
    labels = rng.randint(1, V, (Bn, U)).astype(np.int32)
    f_len = np.array([7, 5, 1], np.int32)
    y_len = np.array([4, 2, 0], np.int32)
    wts = np.array([1.0, 0.5, 2.0], np.float32)

    def jloss(xx):
        lp = jax.nn.log_softmax(xx, axis=-1)
        per = jtr.transducer_loss(lp, jnp.asarray(labels),
                                  jnp.asarray(f_len), jnp.asarray(y_len))
        return jnp.sum(per * wts), per

    (_, jper), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(x))
    tx = torch.tensor(x).requires_grad_(True)
    per = ttr.TransducerLoss()(torch.log_softmax(tx, -1),
                               torch.tensor(labels), torch.tensor(f_len),
                               torch.tensor(y_len))
    (per * torch.tensor(wts)).sum().backward()
    _close(per, jper, atol=0, rtol=1e-4)
    assert torch.isfinite(tx.grad).all()
    _close(tx.grad, jg, atol=1e-5)


def test_groupbn_one_rank_matches_jax():
    """BatchNorm2d_NHWC without a group: fuse_relu, and the add-ReLU with
    z; output and running statistics."""
    rng = np.random.RandomState(7)
    x = rng.randn(4, 3, 3, 6).astype(np.float32)
    z = rng.randn(4, 3, 3, 6).astype(np.float32)
    for fuse, zz in ((True, None), (False, z)):
        jb = jgbn.BatchNorm2d_NHWC(6, fuse_relu=fuse)
        jp, js = jb.init()
        jy, jst = jax.jit(lambda p, st, xx, z, jb=jb: jb.apply(
            p, st, xx, training=True, z=z))(
                jp, js, jnp.asarray(x), None if zz is None else jnp.asarray(zz))
        tb = tgbn.BatchNorm2d_NHWC(6, fuse_relu=fuse, device="cpu")
        tp, ts = tb.init(device="cpu")
        ty, tst = tb.apply(tp, ts, torch.tensor(x), training=True,
                           z=None if zz is None else torch.tensor(zz))
        _close(ty, jy)
        for k in ("running_mean", "running_var"):
            _close(tst[k], jst[k], what=k)
        fy = tb(torch.tensor(x), None if zz is None else torch.tensor(zz))
        _close(fy, jy)
    with pytest.raises(ValueError, match="bn_group"):
        tgbn.BatchNorm2d_NHWC(6, bn_group=2, device="cpu")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_create_mask_matches_jax(dtype):
    """2:4 masks of a (16, 32) weight, with ties (values rounded to a
    few levels; more in bf16)."""
    rng = np.random.RandomState(8)
    w = np.round(rng.randn(16, 32) * 2) / 2
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jsp.create_mask(jnp.asarray(w, jdt)).astype(
        jnp.float32))
    got = tsp.create_mask(torch.tensor(w).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert float(got.float().sum()) == w.size / 2
    np.testing.assert_allclose(
        float(tsp.magnitude_after_mask(torch.tensor(w, dtype=torch.float32))),
        float(jsp.magnitude_after_mask(jnp.asarray(w, jnp.float32))),
        rtol=1e-6)


@pytest.mark.parametrize("cols,max_cols", [(48, 24)])
def test_search_channel_permutation_matches_jax(cols, max_cols):
    """The same permutation and score; 48 columns at max_cols 24 take the
    halves-and-fixup route, which runs the greedy rounds on each half and
    at full width."""
    rng = np.random.RandomState(9 + cols)
    w = rng.randn(16, cols).astype(np.float32)
    jperm, jscore = jsp.search_channel_permutation(jnp.asarray(w),
                                                   max_cols=max_cols)
    tperm, tscore = tsp.search_channel_permutation(torch.tensor(w),
                                                   max_cols=max_cols)
    np.testing.assert_array_equal(np.asarray(tperm), np.asarray(jperm))
    np.testing.assert_allclose(tscore, jscore, rtol=1e-6)
    base = float(tsp.magnitude_after_mask(torch.tensor(w)))
    assert tscore >= base - 1e-4


def test_asp_matches_jax():
    """ASP over a nested dict: the eligible leaves (by path, as the JAX
    package picks them), their masks, the masked tree, re-application
    after an update and the sparsity."""
    rng = np.random.RandomState(10)
    tree = {"layer": {"weight": rng.randn(16, 32), "bias": rng.randn(32)},
            "w": rng.randn(8, 8), "emb": rng.randn(12, 8),
            "odd_weight": rng.randn(6, 8)}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    ja = jsp.ASP()
    jout = ja.init_model_for_pruning(jax.tree_util.tree_map(jnp.asarray,
                                                            tree))
    ta = tsp.ASP()
    tout = ta.init_model_for_pruning(jax.tree_util.tree_map(torch.tensor,
                                                            tree))
    assert sorted(ta.masks) == sorted(ja.masks)
    for key in ja.masks:
        np.testing.assert_array_equal(ta.masks[key].numpy(),
                                      np.asarray(ja.masks[key]))
    for a, b in zip(jax.tree_util.tree_leaves(jout),
                    jax.tree_util.tree_leaves(tout)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    bumped = jax.tree_util.tree_map(lambda a: a + 1.0, tree)
    jre = ja.apply(jax.tree_util.tree_map(jnp.asarray, bumped))
    tre = ta.apply(jax.tree_util.tree_map(torch.tensor, bumped))
    for a, b in zip(jax.tree_util.tree_leaves(jre),
                    jax.tree_util.tree_leaves(tre)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert ta.sparsity() == pytest.approx(ja.sparsity(None))


# --------------------------- the gloo world ---------------------------------

def _inputs():
    rng = np.random.RandomState(11)
    return {"scenarios": ["contrib"], "contrib": {
        "x": rng.randn(2, 32, 8, 3).astype(np.float32),
        "w": (rng.randn(3, 3, 3, 5) * 0.2).astype(np.float32),
        "gy": rng.randn(2, 32, 8, 5).astype(np.float32),
        "bn_x": rng.randn(16, 2, 2, 6).astype(np.float32),
        "bn_z": rng.randn(16, 2, 2, 6).astype(np.float32)}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("contrib"))
    inp = _inputs()
    return inp["contrib"], W.run_ranks(d, WORLD, inp)


def test_spatial_conv2d_across_ranks_matches_dense(ranks):
    d, outs = ranks
    jx, jw = jnp.asarray(d["x"]), jnp.asarray(d["w"])
    y, vjp = jax.vjp(lambda x, w: jconv2d(x, w, padding="SAME"), jx, jw)
    gx, gw = vjp(jnp.asarray(d["gy"]))
    got_y = np.concatenate([o["contrib"]["y"] for o in outs], axis=1)
    got_gx = np.concatenate([o["contrib"]["gx"] for o in outs], axis=1)
    _close(got_y, y, atol=1e-5)
    _close(got_gx, gx, atol=1e-5)
    for o in outs:          # OHWI, summed over the ranks
        _close(o["contrib"]["gw"].transpose(1, 2, 3, 0), gw, atol=1e-4)


def test_peer_halo_exchanger_across_ranks(ranks):
    _, outs = ranks
    for r, o in enumerate(outs):
        left, right = o["contrib"]["left"], o["contrib"]["right"]
        assert left.ravel().tolist() == [(8 * r - 1) % 32]
        assert right.ravel().tolist() == [(8 * r + 8) % 32]


def test_groupbn_two_groups_of_two_match_jax(ranks):
    """Ranks (0, 1) and (2, 3) merge their statistics within their group
    (fuse_relu with the add-ReLU of z); the JAX module does it over the
    "bn" sub-axis of a (2, 2) mesh."""
    d, outs = ranks
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dpo", "bn"))
    bn = jgbn.BatchNorm2d_NHWC(6, fuse_relu=True, bn_group=2, axis_name="bn")
    params, state = bn.init()

    def local(x, z):
        y, st = bn.apply(params, state, x, training=True, z=z)
        return y, st["running_mean"][None], st["running_var"][None]

    y, rm, rv = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(("dpo", "bn")), P(("dpo", "bn"))),
        out_specs=(P(("dpo", "bn")), P(("dpo", "bn")), P(("dpo", "bn"))),
        check_vma=False))(jnp.asarray(d["bn_x"]), jnp.asarray(d["bn_z"]))
    got = np.concatenate([o["contrib"]["bn"] for o in outs])
    _close(got, y, atol=1e-5)
    for r, o in enumerate(outs):
        _close(o["contrib"]["bn_rm"], rm[r], what="running mean")
        _close(o["contrib"]["bn_rv"], rv[r], what="running var")
