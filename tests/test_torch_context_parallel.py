"""The port's context parallelism (apex_tpu_torch.parallel.context_parallel,
the flash kernels' chunk entry points `_fwd_impl` / `_bwd_impl` and
examples/torch_long_context_training.py) against the JAX package's, on
the CPU.  Mirrors tests/test_context_parallel.py.

The multi-rank cases run the port as one 4-rank gloo world started by its
launcher (tests/torch_dist_worker.py, scenario `cp`), ringing over the tp
group at tp = 4; the JAX package runs `shard_map` over "tp" on a mesh of
its first 4 CPU devices (`initialize_model_parallel(
tensor_model_parallel_size=4)`), its jnp chunk path.  Inputs are seeded
numpy, fp32, b 1-2, h 2 (Ulysses 4), s_local 64, d 32.  Cases: the
contiguous ring causal and not, with and without segment ids (o and the
gradients for a given do); the zigzag ring with and without segment ids;
dropout 0.1 in both layouts, both sides given the JAX draw from one key
as the int32 seed (below `ring_attention`), and the keep masks of every
chunk pair at their global offsets equal bit for bit; Ulysses causal and
not, with segment ids, use_flash True and False; the argument errors
with the JAX messages; `zigzag_shard` / `zigzag_unshard` element for
element; `_fwd_impl` / `_bwd_impl` at q_off / k_off != 0 with
`grad_dtype=float32` against the JAX ones (Pallas, interpret mode); one
ring through the JAX Pallas chunk path (interpret) at s_local 16; the
virtual-rank drive (`emulate_ring`, run by rank 0 in its process) equal
to the gloo world's o and gradients BIT FOR BIT; and two steps of the
long-context example (seq 512, hidden 32, 2 heads, 2 layers, vocab 64)
from the JAX example's `init_params`, against that example's
`forward_loss` and step on 4 devices.

Tolerances (fp32): outputs rtol 1e-5 (atol 1e-6 of the largest
magnitude, for entries near zero); gradients rtol 1e-5 and atol 1e-5 of
each tensor's largest magnitude (the port sums partials in its own
order, not XLA's); the example's losses rtol 1e-5."""

import importlib
import importlib.util
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.ops import flash_attention as jfa
from apex_tpu.parallel import context_parallel as jcp
from apex_tpu.parallel import mesh as JM
from apex_tpu_torch.ops import flash_attention as tfa
from apex_tpu_torch.parallel import context_parallel as cp

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

WORLD = 4
B, H, S, D = 1, 2, 256, 32        # s_local 64
RATE = 0.1
# (name, layout, causal, segment ids, dropout)
RING = [("contig", "contiguous", False, False, False),
        ("contig_causal", "contiguous", True, False, False),
        ("contig_seg", "contiguous", False, True, False),
        ("contig_causal_seg", "contiguous", True, True, False),
        ("zigzag", "zigzag", True, False, False),
        ("zigzag_seg", "zigzag", True, True, False),
        ("contig_dropout", "contiguous", True, False, True),
        ("zigzag_dropout", "zigzag", True, False, True)]
ULYSSES = [(causal, use_flash) for causal in (False, True)
           for use_flash in (False, True)]
EXAMPLE = dict(seq=512, hidden=32, heads=2, layers=2, vocab=64, steps=2,
               lr=3e-3)


def _seed():
    """The JAX package's int32 draw from its key, as its ring_attention
    draws it."""
    return int(jax.random.randint(jax.random.PRNGKey(7), (1, 1), -2 ** 31,
                                  2 ** 31 - 1, dtype=jnp.int32)[0, 0])


def _qkvd(seed, b=B, h=H, s=S, d=D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32)
            for _ in range(4)]


def _seg(b, s, run):
    """Segment ids with runs of `run` tokens, spanning shard boundaries."""
    return np.repeat((np.arange(s) // run)[None], b, axis=0).astype(np.int32)


def _ring_case(i, name, layout, causal, seg, drop):
    b = 2 if seg else B
    q, k, v, do = _qkvd(100 + i, b=b)
    ids = _seg(b, S, 40) if seg else None
    if layout == "zigzag":
        # the global sequence in zigzag order: rank r's contiguous shard
        # is the pair (r, 2n-1-r)
        q, k, v, do = (np.asarray(jcp.zigzag_shard(jnp.asarray(x), WORLD))
                       for x in (q, k, v, do))
        if ids is not None:
            ids = np.asarray(jcp.zigzag_shard(jnp.asarray(ids), WORLD,
                                              axis=1))
    return {"name": name, "layout": layout, "causal": causal, "q": q,
            "k": k, "v": v, "do": do, "seg": ids,
            "rate": RATE if drop else 0.0, "seed": _seed() if drop else None}


def _ulysses_case(causal, use_flash):
    q, k, v, do = _qkvd(200 + 2 * causal + use_flash, b=2, h=4)
    return {"name": (causal, use_flash), "causal": causal,
            "use_flash": use_flash, "q": q, "k": k, "v": v, "do": do,
            "seg": _seg(2, S, 50)}


def _example_module():
    """The JAX example, imported from its file (its header puts the repo
    and examples/ on sys.path; with no --force-cpu-devices in argv its
    bootstrap does nothing)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(here, "examples"))
    return importlib.import_module("long_context_training")


def _example_args():
    import argparse

    return argparse.Namespace(**EXAMPLE)


def _example_data():
    rng = np.random.default_rng(300)
    a = _example_args()
    base = rng.integers(0, a.vocab, a.seq)
    tokens = ((base + np.roll(base, 1)) % a.vocab).astype(np.int32)
    labels = np.roll(tokens, -1).astype(np.int32)
    pos = np.arange(a.seq, dtype=np.int32)
    return tuple(np.asarray(jcp.zigzag_shard(jnp.asarray(x)[None], WORLD,
                                             axis=1)[0])
                 for x in (tokens, labels, pos))


def _example_params():
    ex = _example_module()
    tree = ex.init_params(jax.random.PRNGKey(0), _example_args())
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs():
    tokens, labels, pos = _example_data()
    argv = [f"--{k}={v}" for k, v in EXAMPLE.items()]
    return {"scenarios": ["cp"],
            "cp": {"ring": [_ring_case(i, *c) for i, c in enumerate(RING)],
                   "ulysses": [_ulysses_case(*c) for c in ULYSSES],
                   "example": {"argv": argv, "params": _example_params(),
                               "tokens": tokens, "labels": labels,
                               "pos": pos}}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("cp4")
    inputs = _inputs()
    return inputs["cp"], W.run_ranks(str(d), WORLD, inputs)


def _jmesh():
    JM.destroy_model_parallel()
    return JM.initialize_model_parallel(tensor_model_parallel_size=WORLD,
                                        devices=jax.devices()[:WORLD])


def _close_out(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max(), err_msg=what)


def _close_grad(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


def _gathered(outs, key, name):
    """Every rank's (o, dq, dk, dv) concatenated along the sequence."""
    return [np.concatenate([o["cp"][key][name][i] for o in outs], axis=2)
            for i in range(4)]


def _jax_ring(c):
    """The JAX ring's output and gradients (given do) in shard_map over
    "tp"; with dropout through `_ring` / `_ring_zz` on the test's seed."""
    mesh = _jmesh()
    spec = P(None, None, "tp")
    scale = 1.0 / math.sqrt(D)
    seed = (None if c["seed"] is None
            else jnp.asarray([[c["seed"]]], jnp.int32))
    has_seg = c["seg"] is not None

    def local(q, k, v, do, *seg):
        s_ = seg[0] if seg else None

        def f(q, k, v):
            if c["rate"] and c["layout"] == "zigzag":
                return jcp._ring_zz(q, k, v, s_, s_, seed, "tp", scale, None,
                                    None, False, c["rate"])
            if c["rate"]:
                return jcp._ring(q, k, v, s_, s_, seed, "tp", c["causal"],
                                 scale, None, None, False, c["rate"])
            return jcp.ring_attention(q, k, v, "tp", causal=c["causal"],
                                      segment_ids=s_, layout=c["layout"])

        o, vjp = jax.vjp(f, q, k, v)
        return (o,) + vjp(do)

    args = [jnp.asarray(c[x]) for x in ("q", "k", "v", "do")]
    specs = [spec] * 4
    if has_seg:
        args.append(jnp.asarray(c["seg"]))
        specs.append(P(None, "tp"))
    out = jax.jit(shard_map(local, mesh=mesh, in_specs=tuple(specs),
                            out_specs=(spec,) * 4, check_vma=False))(*args)
    JM.destroy_model_parallel()
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("case", RING, ids=[c[0] for c in RING])
def test_ring_matches_jax(ranks, case):
    """Each rank's output shard and dq, dk, dv (given do) are the JAX
    ring's in shard_map, in both layouts, causal and not, with segment
    ids and with dropout (one int32 seed on both sides)."""
    inputs, outs = ranks
    c = next(x for x in inputs["ring"] if x["name"] == case[0])
    got = _gathered(outs, "ring", case[0])
    want = _jax_ring(c)
    _close_out(got[0], want[0], f"{case[0]} o")
    for g, w, what in zip(got[1:], want[1:], ("dq", "dk", "dv")):
        _close_grad(g, w, f"{case[0]} {what}")


@pytest.mark.parametrize("case", RING, ids=[c[0] for c in RING])
def test_virtual_ranks_equal_the_gloo_world_bitwise(ranks, case):
    """`emulate_ring` (n = 4 virtual ranks in one process, through the
    ring's own step functions) gives the gloo world's o, dq, dk and dv
    bit for bit: the same functions, the same order of fp32 sums."""
    _, outs = ranks
    emu = outs[0]["cp"]["emulated"][case[0]]
    for r, o in enumerate(outs):
        for i, what in enumerate(("o", "dq", "dk", "dv")):
            np.testing.assert_array_equal(
                emu[i][r], o["cp"]["ring"][case[0]][i],
                err_msg=f"{case[0]} rank {r} {what}")


def test_ring_dropout_masks_agree_bitwise():
    """Every chunk pair's keep mask at its global offsets (contiguous:
    rank r's queries, chunk src's keys; zigzag: the half-chunk pairs):
    the port's `dropout_keep_dense` is the JAX package's bit for bit."""
    seed = _seed()
    s = S // WORLD
    offs = {(r * s, src * s, s) for r in range(WORLD) for src in range(WORLD)}
    half = s // 2
    offs |= {(a * half, c * half, half) for a in range(2 * WORLD)
             for c in range(2 * WORLD)}
    for q_off, k_off, n in sorted(offs):
        got = tfa.dropout_keep_dense(seed, B, H, n, n, RATE, q_off, k_off)
        want = jfa.dropout_keep_dense(jnp.asarray([[seed]], jnp.int32), B, H,
                                      n, n, RATE, q_off, k_off)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"offsets {q_off}, {k_off}")


@pytest.mark.parametrize("case", ULYSSES, ids=lambda c: f"causal{c[0]}-"
                         f"flash{c[1]}")
def test_ulysses_matches_jax(ranks, case):
    """Ulysses with segment ids, causal and not, use_flash True and
    False: each rank's output shard and gradients are the JAX one's."""
    inputs, outs = ranks
    c = next(x for x in inputs["ulysses"] if x["name"] == case)
    got = _gathered(outs, "ulysses", case)
    mesh = _jmesh()
    spec = P(None, None, "tp")

    def local(q, k, v, do, seg):
        def f(q, k, v):
            return jcp.ulysses_attention(q, k, v, "tp", causal=c["causal"],
                                         segment_ids=seg,
                                         use_flash=c["use_flash"])

        o, vjp = jax.vjp(f, q, k, v)
        return (o,) + vjp(do)

    want = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(spec,) * 4 + (P(None, "tp"),),
        out_specs=(spec,) * 4, check_vma=False))(
        *(jnp.asarray(c[x]) for x in ("q", "k", "v", "do", "seg")))
    JM.destroy_model_parallel()
    _close_out(got[0], want[0], "ulysses o")
    for g, w, what in zip(got[1:], want[1:], ("dq", "dk", "dv")):
        _close_grad(g, w, f"ulysses {what}")


def test_example_losses_match_jax(ranks):
    """Two steps of examples/torch_long_context_training.py in the 4-rank
    gloo world, from the JAX example's `init_params` through
    `params_from_jax`, give the JAX example's losses (its `forward_loss`
    and step in shard_map over a 4-device "cp" mesh)."""
    inputs, outs = ranks
    ex = _example_module()
    from apex_tpu.optimizers import flat as JF
    from apex_tpu.optimizers.fused_adam import FusedAdam as JFusedAdam
    from jax import lax

    a = _example_args()
    e = inputs["example"]
    opt = JFusedAdam(lr=a.lr, use_pallas=False)
    opt_state = opt.init(jax.tree_util.tree_map(jnp.asarray, e["params"]))
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("cp",))

    def step_fn(opt_state, t, lab, p_ids):
        p_tree = JF.unflatten(opt_state.params, opt.spec)
        loss, grads = jax.value_and_grad(
            lambda p: ex.forward_loss(p, t, lab, p_ids, a))(p_tree)
        grads = jax.tree_util.tree_map(lambda g: lax.pmean(g, "cp"), grads)
        _, opt_state = opt.step(opt_state, grads)
        return opt_state, loss

    step = jax.jit(shard_map(step_fn, mesh=mesh,
                             in_specs=(P(), P("cp"), P("cp"), P("cp")),
                             out_specs=(P(), P()), check_vma=False))
    want = []
    for _ in range(a.steps):
        opt_state, loss = step(opt_state, *(jnp.asarray(e[x]) for x in (
            "tokens", "labels", "pos")))
        want.append(float(loss))
    for o in outs:
        np.testing.assert_allclose(o["cp"]["example"], want, rtol=1e-5)
    assert want[1] < want[0]


def test_zigzag_shard_matches_jax():
    """zigzag_shard / zigzag_unshard are the JAX functions element for
    element, along the sequence axis and along axis 1, and undo each
    other."""
    x = np.arange(3 * 2 * 48 * 2, dtype=np.float32).reshape(3, 2, 48, 2)
    for n in (1, 2, 4, 8):
        got = cp.zigzag_shard(torch.from_numpy(x), n)
        want = np.asarray(jcp.zigzag_shard(jnp.asarray(x), n))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            cp.zigzag_unshard(got, n).numpy(), x)
        np.testing.assert_array_equal(
            cp.zigzag_unshard(torch.from_numpy(want.copy()), n).numpy(),
            np.asarray(jcp.zigzag_unshard(jnp.asarray(want), n)))
    ids = np.arange(2 * 32).reshape(2, 32)
    np.testing.assert_array_equal(
        cp.zigzag_shard(torch.from_numpy(ids), 4, axis=1).numpy(),
        np.asarray(jcp.zigzag_shard(jnp.asarray(ids), 4, axis=1)))
    with pytest.raises(ValueError, match="seq_len % \\(2\\*n\\)"):
        cp.zigzag_shard(torch.zeros(1, 1, 12, 2), 4)


def _message(fn, *a, **kw):
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return str(e.value)


@pytest.mark.parametrize("what", [
    "layout", "zigzag_causal", "zigzag_odd", "dropout_key", "seg_both",
    "seg_pair", "seg_shape"])
def test_ring_argument_errors_match_jax(what):
    """The argument checks raise ValueError with the JAX messages: an
    unknown layout, zigzag without causal, an odd local sequence under
    zigzag, dropout without a key, segment_ids beside q_/kv_ ids, one of
    q_/kv_ ids alone, ids of the wrong shape."""
    q = np.zeros((1, 2, 16, 8), np.float32)
    q_odd = np.zeros((1, 2, 15, 8), np.float32)
    ids = np.zeros((1, 16), np.int32)
    kw = {"layout": dict(layout="ring"),
          "zigzag_causal": dict(layout="zigzag"),
          "zigzag_odd": dict(layout="zigzag", causal=True),
          "dropout_key": dict(dropout_rate=0.1),
          "seg_both": dict(segment_ids=ids, q_segment_ids=ids),
          "seg_pair": dict(q_segment_ids=ids),
          "seg_shape": dict(segment_ids=np.zeros((1, 8), np.int32))}[what]
    x = q_odd if what == "zigzag_odd" else q
    got = _message(cp.ring_attention, *(torch.from_numpy(x),) * 3, "tp",
                   **{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                      else v for k, v in kw.items()})
    want = _message(jcp.ring_attention, *(jnp.asarray(x),) * 3, "tp",
                    **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                       else v for k, v in kw.items()})
    assert got == want


@pytest.mark.parametrize("causal", [False, True])
def test_chunk_entry_points_match_jax_at_offsets(causal):
    """`_fwd_impl` / `_bwd_impl` at q_off 4096, k_off 128 with dropout
    0.1 and grad_dtype=float32: o, lse and fp32 dq, dk, dv against the
    JAX `_fwd_impl` / `_bwd_impl` (Pallas, interpret mode) with the same
    seed and offsets; the gradients come back fp32."""
    q, k, v, do = _qkvd(400 + causal, b=1, h=2, s=128, d=64)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(64)
    seed = _seed()
    jseed = jnp.asarray([[seed]], jnp.int32)
    kw = dict(q_off=4096, k_off=128)
    o, lse = jfa._fwd_impl(jq, jk, jv, scale, causal, RATE, jseed, **kw)
    want = jfa._bwd_impl(jq, jk, jv, o, lse, jdo, scale, causal, RATE, jseed,
                         grad_dtype=jnp.float32, **kw)[:3]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    to, tlse = tfa._fwd_impl(tq, tk, tv, scale, causal, RATE, seed, **kw)
    got = tfa._bwd_impl(tq, tk, tv, to, tlse, tdo, scale, causal, RATE, seed,
                        grad_dtype=torch.float32, **kw)
    assert got[3] is None
    _close_out(to.numpy(), o, "o")
    _close_out(tlse.numpy(), lse, "lse")
    for g, w, what in zip(got[:3], want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        _close_grad(g.numpy(), w, what)
    # bf16 inputs: the fp32 gradients are the default's before rounding
    bq, bk, bv, bdo = (x.to(torch.bfloat16) for x in (tq, tk, tv, tdo))
    bo, blse = tfa._fwd_impl(bq, bk, bv, scale, causal, RATE, seed, **kw)
    g32 = tfa._bwd_impl(bq, bk, bv, bo, blse, bdo, scale, causal, RATE, seed,
                        grad_dtype=torch.float32, **kw)[:3]
    g16 = tfa._bwd_impl(bq, bk, bv, bo, blse, bdo, scale, causal, RATE, seed,
                        **kw)[:3]
    for a32, a16 in zip(g32, g16):
        assert a32.dtype == torch.float32 and a16.dtype == torch.bfloat16
        assert torch.equal(a32.to(torch.bfloat16), a16)


def test_chunk_entry_points_refuse_bias():
    """A bias or dbias is refused (ROADMAP Queue 2 item 38)."""
    x = torch.zeros(1, 1, 8, 8)
    with pytest.raises(NotImplementedError, match="item 38"):
        tfa._fwd_impl(x, x, x, 1.0, False, bias=x)
    with pytest.raises(NotImplementedError, match="item 38"):
        tfa._bwd_impl(x, x, x, x, x[..., 0], x, 1.0, False,
                      want_dbias=True)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_pallas_chunk_path_matches_port(causal):
    """The JAX ring through its Pallas chunk kernels (interpret mode) at
    the smallest size they take (1, 1, 64, 16) over 4 devices, against
    the port's ring emulated on 4 virtual ranks (plain versions)."""
    q, k, v, do = _qkvd(500 + causal, b=1, h=1, s=64, d=16)
    mesh = _jmesh()
    spec = P(None, None, "tp")

    def local(q, k, v, do):
        o, vjp = jax.vjp(lambda q, k, v: jcp.ring_attention(
            q, k, v, "tp", causal=causal, use_pallas_override=True), q, k, v)
        return (o,) + vjp(do)

    want = jax.jit(shard_map(local, mesh=mesh, in_specs=(spec,) * 4,
                             out_specs=(spec,) * 4, check_vma=False))(
        *(jnp.asarray(x) for x in (q, k, v, do)))
    JM.destroy_model_parallel()
    shards = [[torch.from_numpy(s_.copy()) for s_ in np.split(x, WORLD, 2)]
              for x in (q, k, v, do)]
    got = [np.concatenate([t.numpy() for t in lst], axis=2)
           for lst in cp.emulate_ring(*shards, causal=causal)]
    _close_out(got[0], want[0], "o")
    for g, w, what in zip(got[1:], want[1:], ("dq", "dk", "dv")):
        _close_grad(g, w, what)


def test_ring_at_one_rank_is_flash_attention():
    """Without a group (a world of one) the contiguous ring is one chunk
    merged into the empty state: its output and gradients are the plain
    flash forward's and backward's bit for bit (fp32 partials rounded
    once), causal, with segment ids."""
    q, k, v, do = (torch.from_numpy(x) for x in _qkvd(600, s=64))
    ids = torch.from_numpy(_seg(B, 64, 20))
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = cp.ring_attention(qr, kr, vr, "tp", causal=True, segment_ids=ids)
    o.backward(do)
    scale = 1.0 / math.sqrt(D)
    want_o, lse = tfa._fwd_impl(q, k, v, scale, True, q_seg=ids, kv_seg=ids)
    want = tfa._bwd_impl(q, k, v, want_o, lse, do, scale, True, q_seg=ids,
                         kv_seg=ids, grad_dtype=torch.float32)
    assert torch.equal(o.detach(), want_o)
    for got, w in zip((qr.grad, kr.grad, vr.grad), want[:3]):
        assert torch.equal(got, w)


def _chip_smoke():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name, f32, drop", [
    ("_Z16flash_bwd_kernelILi64ELb0ELb1ELb1ELb0EEv7BwdArgs",
     "_Z16flash_bwd_kernelILi64ELb0ELb1ELb0ELb0EEv7BwdArgs", None),
    ("_Z16flash_bwd_kernelILi128ELb1ELb0ELb1ELb1EEv7BwdArgs",
     "_Z16flash_bwd_kernelILi128ELb1ELb0ELb0ELb1EEv7BwdArgs",
     "_Z16flash_bwd_kernelILi128ELb1ELb0ELb1ELb0EEv7BwdArgs"),
    ("_Z19flash_bwd_dq_kernelILi64ELb1ELb1ELb1EEv6DqArgs",
     "_Z19flash_bwd_dq_kernelILi64ELb1ELb0ELb1EEv6DqArgs",
     "_Z19flash_bwd_dq_kernelILi64ELb1ELb1ELb0EEv6DqArgs"),
    ("_Z16flash_bwd_kernelILi64ELb0ELb1ELb0ELb1EEv7BwdArgs", None,
     "_Z16flash_bwd_kernelILi64ELb0ELb1ELb0ELb0EEv7BwdArgs"),
    ("_Z23flash_bwd_packed_kernelILi64ELb0ELb1EEv7BwdArgsi", None,
     "_Z23flash_bwd_packed_kernelILi64ELb0ELb0EEv7BwdArgsi")])
def test_chip_smoke_twins_of_the_flash_instantiations(name, f32, drop):
    """chip_smoke's phase-1 gates pair each fp32-output instantiation
    (the flag before the last template argument of the fused / dk/dv
    kernel and the dq pass) with its bf16 twin, and each dropout one
    (the last argument) with its rate-0 twin; other kernels have none."""
    C = _chip_smoke()
    assert C.f32_twin(name) == f32
    assert C.dropout_twin(name) == drop
