"""The port's additive flash bias and its attention modules
(apex_tpu_torch.ops.flash_attention with a bias, apex_tpu_torch.contrib
.multihead_attn and .fmha) against the JAX package's, on the CPU.

  * The bias plain versions (`flash_fwd_reference`,
    `flash_bwd_dq_reference` / `flash_bwd_dkv_reference` with
    `want_dbias`, reduced by `_reduce_db`) against the JAX `_fwd_impl` /
    `_bwd_impl` in Pallas interpret mode, (2, 2, 128, 64) fp32 with 64 x
    64 blocks: kinds "full", "sk" and query-compact, batch and head
    broadcast, with and without segment ids, causal or not; the backward
    on the fused route and (a full and a key-compact case), with
    `_FUSED_BWD_CAP` monkeypatched to 1, on the split route, in one test
    a case.  Tolerance 1e-5 absolute (the flash file's fp32 tolerance);
    dbias 1e-4 absolute, a sum over up to 256 fp32 terms.
  * `_FlashFn`'s bias routes with counting stand-ins for the launchers
    (the plain versions behind them), its gradients against autograd
    through `attention_reference`, and the tuner's key.
  * SelfMultiheadAttn / EncdecMultiheadAttn through `params_from_jax`
    against the JAX modules (each on its CPU path: attention_reference
    with the same masks), every mask route through each module, norm-add
    on and off for each, forward and the gradients of the parameters and
    the input, fp32 at 2e-5 absolute (both sides sum fp32 products in
    different orders).  At dropout > 0 the two frameworks draw different
    masks: the keep fraction and the output's mean are compared.
  * FMHA with `cu_seqlens` against the JAX FMHA; the example on the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import fmha as jfmha
from apex_tpu.contrib import multihead_attn as jmha
from apex_tpu.ops import flash_attention as jfa
from apex_tpu_torch.contrib import fmha as tfmha
from apex_tpu_torch.contrib import multihead_attn as tmha
from apex_tpu_torch.ops import flash_attention as tfa

B, H, S, D = 2, 2, 128, 64
SCALE = 1.0 / math.sqrt(D)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread (see tests/test_torch_flash_attention.py: torch's
    vector math on a worker thread sometimes rounds otherwise once JAX
    has run in the process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _inputs(seed, bias_shape):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, H, S, D).astype(np.float32)
                   for _ in range(4))
    bias = rng.randn(*bias_shape).astype(np.float32)
    return q, k, v, do, bias


def _segments(seed):
    rng = np.random.RandomState(seed)
    return np.stack([np.sort(rng.randint(0, 3, S)) for _ in range(B)]
                    ).astype(np.int32)


# kind, bias shape, causal, segment ids, the split route too: each kind,
# batch and head broadcast, causal or not, segment ids or not, and each
# dbias kind on both routes
_CASES = [
    ("full", (1, H, S, S), True, False, True),
    ("full", (B, 1, S, S), False, True, False),
    ("sk", (B, 1, 1, S), True, False, True),
    ("sk", (1, H, 1, S), False, True, False),
    ("none", (1, 1, S, 1), True, False, False),
]


def _jax_pass(monkeypatch, q, k, v, do, bias, causal, seg, split):
    """The JAX forward (o, lse) and its backward (dq, dk, dv, dbias) on
    the fused route and, with `split`, also with `_FUSED_BWD_CAP` shrunk
    to 1 while it is traced, on the split route, in one jit."""
    want = bias.shape[3] != 1
    cap = jfa._FUSED_BWD_CAP

    def run(jq, jk, jv, jdo, jb, js):
        o, lse = jfa._fwd_impl(jq, jk, jv, SCALE, causal, block_q=64,
                               block_k=64, bias=jb, q_seg=js, kv_seg=js)
        routes = {}
        for route in ("fused", "split") if split else ("fused",):
            monkeypatch.setattr(jfa, "_FUSED_BWD_CAP",
                                1 if route == "split" else cap)
            routes[route] = jfa._bwd_impl(
                jq, jk, jv, o, lse, jdo, SCALE, causal, block_q=64,
                block_k=64, bias=jb, q_seg=js, kv_seg=js, want_dbias=want)
        monkeypatch.setattr(jfa, "_FUSED_BWD_CAP", cap)
        return o, lse, routes

    return jax.jit(run)(*(jnp.asarray(x) for x in (q, k, v, do, bias)),
                        None if seg is None else jnp.asarray(seg))


def _port_pass(q, k, v, do, bias, causal, seg):
    tq, tk, tv, tdo, tb = (torch.tensor(x) for x in (q, k, v, do, bias))
    ts = None if seg is None else torch.tensor(seg)
    o, lse = tfa.flash_fwd_reference(tq, tk, tv, SCALE, causal, ts, ts,
                                     bias=tb)
    delta = torch.sum(tdo * o, dim=-1)
    args = (tq, tk, tv, tdo, lse, delta, SCALE, causal, ts, ts)
    kind = tfa._bias_kind(tb, S)
    dq, db_full = tfa.flash_bwd_dq_reference(*args, bias=tb,
                                             want_dbias=True)
    dk, dv, db_sk = tfa.flash_bwd_dkv_reference(*args, bias=tb,
                                                want_dbias=True)
    db = None
    if kind == "full":
        db = tfa._reduce_db(db_full, tb.shape)
    elif kind == "sk":
        db = tfa._reduce_db(db_sk, tb.shape)[:, :, None, :]
    return o, lse, dq, dk, dv, db


@pytest.mark.parametrize("kind,shape,causal,seg,split", _CASES)
def test_bias_plain_versions_match_jax_kernels(monkeypatch, kind, shape,
                                               causal, seg, split):
    q, k, v, do, bias = _inputs(len(shape) + sum(shape) + causal, shape)
    ids = _segments(int(causal)) if seg else None
    o, lse, routes = _jax_pass(monkeypatch, q, k, v, do, bias, causal, ids,
                               split)
    got = _port_pass(q, k, v, do, bias, causal, ids)
    assert tfa._bias_kind(torch.tensor(bias), S) == kind
    for name, g, w in (("o", got[0], o), ("lse", got[1], lse)):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5, rtol=0,
                                   err_msg=name)
    for route, want in routes.items():
        for name, g, w in zip(("dq", "dk", "dv"), got[2:5], want):
            np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5, rtol=0,
                                       err_msg=f"{route} {name}")
        if kind == "none":
            assert want[3] is None and got[5] is None
            continue
        assert tuple(got[5].shape) == shape
        np.testing.assert_allclose(got[5].numpy(), _np(want[3]), atol=1e-4,
                                   rtol=0, err_msg=f"{route} dbias")


def test_bias_grad_false_and_query_compact_give_no_gradient():
    """`flash_attention(bias=..., bias_grad=False)` leaves the bias
    without a gradient; a query-compact bias changes nothing (softmax
    cancels it) and its gradient is zero, as in the JAX package."""
    q, k, v, do, bias = _inputs(3, (1, H, S, S))
    tq, tk, tv = (torch.tensor(x).requires_grad_(True) for x in (q, k, v))
    tb = torch.tensor(bias).requires_grad_(True)
    tfa.flash_attention(tq, tk, tv, bias=tb, bias_grad=False).sum().backward()
    assert tb.grad is None and tq.grad is not None
    qc = torch.tensor(np.random.RandomState(4).randn(1, 1, S, 1)
                      .astype(np.float32)).requires_grad_(True)
    o = tfa.flash_attention(tq, tk, tv, bias=qc)
    torch.testing.assert_close(o, tfa.flash_attention(tq, tk, tv),
                               atol=1e-6, rtol=0)
    o.sum().backward()
    assert torch.all(qc.grad.abs() < 1e-6)


def _stand_ins(monkeypatch, calls):
    """The launchers replaced by counting stand-ins that run the plain
    versions (with the keyword arguments they were given)."""
    def fwd(q, k, v, scale, causal, q_seg, kv_seg, **kw):
        calls.append(("fwd", "bias" in kw, kw.get("want_dbias")))
        return tfa.flash_fwd_reference(q, k, v, scale, causal, q_seg,
                                       kv_seg, **kw)

    def fused(*args, **kw):
        calls.append(("fused", "bias" in kw, kw.get("want_dbias")))
        dq = tfa.flash_bwd_dq_reference(*args, **kw)
        kw2 = dict(kw, want_dbias=False) if "bias" in kw else kw
        dq = dq if isinstance(dq, tuple) else (dq,)
        return (dq[0], *tfa.flash_bwd_dkv_reference(*args, **kw2), *dq[1:])

    def dq_pass(*args, **kw):
        calls.append(("dq", "bias" in kw, kw.get("want_dbias")))
        return tfa.flash_bwd_dq_reference(*args, **kw)

    def dkv_pass(*args, **kw):
        calls.append(("dkv", "bias" in kw, kw.get("want_dbias")))
        return tfa.flash_bwd_dkv_reference(*args, **kw)

    for name, fn in (("flash_fwd_cuda", fwd), ("flash_bwd_cuda", fused),
                     ("flash_bwd_dq_cuda", dq_pass),
                     ("flash_bwd_dkv_cuda", dkv_pass)):
        monkeypatch.setattr(tfa, name, fn)


@pytest.mark.parametrize("shape,sk,route", [
    ((1, 2, 64, 256), 256, [("fwd", True, None), ("fused", True, True)]),
    ((2, 1, 1, 256), 256, [("fwd", True, None), ("dq", True, False),
                           ("dkv", True, True)]),
    ((1, 2, 64, 4160), 4160, [("fwd", True, None), ("dq", True, True),
                              ("dkv", True, False)]),
    ((1, 1, 64, 1), 256, [("fwd", False, None), ("fused", False, None)]),
])
def test_flash_fn_bias_routes(monkeypatch, shape, sk, route):
    """"full" dbias stays on the fused route while the cap allows and
    comes from the dq pass past it; "sk" dbias takes the split pair (its
    q-sum is the dk/dv pass's); a query-compact bias reaches no launcher
    and gets a zero gradient.  Gradients, the bias's included, against
    autograd through `attention_reference`."""
    calls = []
    _stand_ins(monkeypatch, calls)
    g = torch.Generator().manual_seed(sk + shape[0])
    q = torch.randn(2, 2, 64, 64, generator=g).requires_grad_(True)
    k, v = (torch.randn(2, 2, sk, 64, generator=g).requires_grad_(True)
            for _ in range(2))
    bias = torch.randn(shape, generator=g).requires_grad_(True)
    out = tfa._FlashFn.apply(q, k, v, 0.125, False, None, None, 1, 0.0,
                             (0, 0, 0), bias, True)
    out.backward(torch.ones_like(out))
    assert calls == route, calls
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v, bias)]
    tfa.attention_reference(*leaves[:3], softmax_scale=0.125,
                            bias=leaves[3]).backward(torch.ones_like(out))
    for got, want in zip((q, k, v, bias), leaves):
        assert got.grad.shape == want.grad.shape
        torch.testing.assert_close(got.grad, want.grad, atol=2e-5, rtol=0)


def test_flash_fn_refuses_a_bias_with_heads_packed_and_asks_the_tuner(
        monkeypatch):
    """`_FlashFn` with hp > 1 and a bias raises (the packed kernels take
    none); `flash_attention` on CUDA (stood in) asks the tuner with the
    call's bias kind and runs a tuned hp > 1 unpacked."""
    x = torch.zeros(1, 2, 64, 64)
    with pytest.raises(NotImplementedError, match="item 38"):
        tfa._FlashFn.apply(x, x, x, 0.125, False, None, None, 2, 0.0,
                           (0, 0, 0), torch.zeros(1, 1, 64, 64), True)
    kinds, got = [], []
    monkeypatch.setattr(tfa, "check_kernel_device", lambda *t: True)
    monkeypatch.setattr(
        tfa, "_tuned_flash_config",
        lambda *a: kinds.append(a[7]) or {"heads_per_step": 2})
    monkeypatch.setattr(tfa._FlashFn, "apply",
                        lambda *args: got.append(args) or args[0])
    for bias, kind, hp in ((torch.zeros(1, 1, 64, 64), "full", 1),
                           (torch.zeros(1, 2, 1, 64), "sk", 1),
                           (torch.zeros(1, 1, 64, 1), "none", 2),
                           (None, "none", 2)):
        tfa.flash_attention(x, x, x, bias=bias)
        assert kinds[-1] == kind and got[-1][7] == hp, (kind, got[-1][7])
    with pytest.raises(NotImplementedError, match="segment ids"):
        ids = torch.zeros(1, 64, dtype=torch.int32)
        tfa.flash_attention(x, x, x, bias=torch.zeros(1, 1, 64, 64),
                            segment_ids=ids)


# ------------------------------ the modules ---------------------------------

SEQ, BATCH, EMBED, HEADS = 16, 2, 32, 4


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return [v for _, v in sorted(_flat(tree).items())]


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "/"))
        else:
            out[prefix + key] = val
    return out


def _masks(rng):
    pad = np.zeros((BATCH, SEQ), bool)
    pad[1, 11:] = True
    fut = np.triu(np.ones((SEQ, SEQ), bool), 1)
    per_head = rng.rand(HEADS, SEQ, SEQ) < 0.3
    per_head[..., 0] = False
    return {"none": None, "key_padding": pad, "future": fut,
            "per_head": per_head}


def _run_both(cls_j, cls_t, norm_add, mask, encdec, seed):
    rng = np.random.RandomState(seed)
    jm = cls_j(EMBED, HEADS, bias=True, include_norm_add=norm_add)
    params = _tree_np(jm.init(jax.random.PRNGKey(seed)))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32), params)
    x = rng.randn(SEQ, BATCH, EMBED).astype(np.float32)
    enc = rng.randn(SEQ, BATCH, EMBED).astype(np.float32) if encdec else None
    dy = rng.randn(SEQ, BATCH, EMBED).astype(np.float32)
    m = _masks(rng)[mask]

    def jloss(p, xx):
        y = jm.apply(p, xx, None if enc is None else jnp.asarray(enc),
                     mask=None if m is None else jnp.asarray(m))
        return jnp.sum(y * dy), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tm = cls_t(EMBED, HEADS, bias=True, include_norm_add=norm_add,
               device="cpu")
    tm.load_params(tmha.params_from_jax(params, device="cpu"))
    tx = torch.tensor(x).requires_grad_(True)
    ty = tm(tx, None if enc is None else torch.tensor(enc),
            mask=None if m is None else torch.tensor(m))
    (ty * torch.tensor(dy)).sum().backward()
    return (jy, jgp, jgx), (ty, tm, tx)


# every mask route through each module, norm-add on and off for each
@pytest.mark.parametrize("encdec,norm_add,mask", [
    (False, False, "none"), (False, True, "key_padding"),
    (False, False, "future"), (False, True, "per_head"),
    (True, True, "none"), (True, False, "key_padding"),
    (True, True, "future"), (True, False, "per_head")])
def test_multihead_attn_matches_jax(encdec, norm_add, mask):
    if encdec:
        cls_j, cls_t = jmha.EncdecMultiheadAttn, tmha.EncdecMultiheadAttn
    else:
        cls_j, cls_t = jmha.SelfMultiheadAttn, tmha.SelfMultiheadAttn
    (jy, jgp, jgx), (ty, tm, tx) = _run_both(
        cls_j, cls_t, norm_add, mask, encdec, seed=7 + norm_add + 2 * encdec)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=2e-5,
                               rtol=0)
    want = _flat(_tree_np(jgp))
    got = {k: v.grad for k, v in _flat(tm.params()).items()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=2e-5, rtol=0,
                                   err_msg=name)


def test_multihead_attn_dropout_keep_fraction_and_mean():
    """Dropout 0.3 through the module: q and k projections 0 (uniform
    attention), v and the output projection the identity, one-hot
    tokens, so each output element is one dropped weight, 1/S/(1 - rate)
    or 0.  The keep fraction and the mean agree with the JAX module's
    (different masks: different draws)."""
    rate, e, s, b = 0.3, 16, 16, 64
    eye = np.eye(e, dtype=np.float32)
    params = {"qkv_weight": np.concatenate(
        [np.zeros((e, 2 * e), np.float32), eye], 1), "out_weight": eye}
    x = np.tile(np.eye(s, e, dtype=np.float32)[:, None], (1, b, 1))
    jm = jmha.SelfMultiheadAttn(e, 1, dropout=rate)
    jy = np.asarray(jax.jit(lambda p, xx, key: jm.apply(
        p, xx, dropout_key=key))(jax.tree_util.tree_map(jnp.asarray, params),
                                  jnp.asarray(x), jax.random.PRNGKey(0)))
    tm = tmha.SelfMultiheadAttn(e, 1, dropout=rate, device="cpu")
    tm.load_params(tmha.params_from_jax(params, device="cpu"))
    ty = tm(torch.tensor(x), dropout_key=torch.Generator().manual_seed(0),
            is_training=True).detach().numpy()
    for y in (jy, ty):
        assert abs((y != 0).mean() - (1 - rate)) < 0.02
        np.testing.assert_allclose(y[y != 0], 1 / s / (1 - rate), rtol=1e-5)
    assert abs(jy.mean() - ty.mean()) < 0.02 / s
    # eval mode: no dropout at all
    tm.eval()
    np.testing.assert_allclose(
        tm(torch.tensor(x), dropout_key=torch.Generator().manual_seed(0))
        .detach().numpy(), np.full_like(ty, 1 / s), atol=1e-6)


def test_fmha_cu_seqlens_matches_jax():
    """FMHA over one packed row of 64 tokens cut by cu_seqlens (the last
    4 tokens a pad segment), and the segment ids themselves."""
    rng = np.random.RandomState(11)
    qkv = rng.randn(1, 64, 3, 2, 16).astype(np.float32)
    cu = np.array([0, 20, 45, 60], np.int32)
    np.testing.assert_array_equal(
        tfmha.segment_ids_from_cu_seqlens(torch.tensor(cu), 64).numpy(),
        np.asarray(jfmha.segment_ids_from_cu_seqlens(jnp.asarray(cu), 64)))
    for causal in (False, True):
        want = np.asarray(jax.jit(lambda x, c, causal=causal: jfmha.FMHA(
            causal)(x, cu_seqlens=c))(jnp.asarray(qkv), jnp.asarray(cu)))
        got = tfmha.FMHA(causal)(torch.tensor(qkv),
                                 cu_seqlens=torch.tensor(cu))
        assert got.shape == (1, 64, 2, 16)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="batch 1"):
        tfmha.FMHAFun.apply(torch.zeros(2, 8, 3, 1, 16),
                            cu_seqlens=torch.tensor(cu))
    with pytest.raises(ValueError, match="not both"):
        tfmha.FMHAFun.apply(torch.zeros(1, 8, 3, 1, 16),
                            segment_ids=torch.zeros(1, 8),
                            cu_seqlens=torch.tensor(cu))


def test_example_runs_on_the_cpu():
    """examples/torch_bench_multihead_attn.py on the CPU at a tiny width:
    the fused and unfused lines, forward and forward + backward, and the
    module's attention global restored afterwards."""
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "torch_bench_multihead_attn.py")
    spec = importlib.util.spec_from_file_location("torch_bench_mha", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    res = ex.run(16, 2, 32, 4, "cpu", iters=1,
                 mask=torch.ones(16, 16, dtype=torch.bool).triu(1))
    assert sorted(res) == ["fused_fwd_ms", "fused_fwdbwd_ms",
                           "unfused_fwd_ms", "unfused_fwdbwd_ms"]
    assert all(v > 0 for v in res.values())
    assert tmha.flash_attention is tfa.flash_attention
