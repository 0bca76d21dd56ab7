"""The PyTorch port's dropout against the JAX package's, on the CPU: the
flash kernels' in-kernel mask (`dropout_keep_dense`), the plain versions
of the flash kernels with dropout against the JAX kernels in interpret
mode on the same int32 seed, `_common.dropout`, and the port's
`transformer.tensor_parallel.random`.

The same seeded numpy inputs go to both packages.  Tolerance: fp32 1e-5
of each output's largest magnitude (both sides take fp32 scores and
softmax in different orders; measured below 1e-6).  The mask is held bit
for bit."""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flash_attention as jfa
from apex_tpu.transformer.tensor_parallel import random as jrandom
from apex_tpu_torch.ops import _common
from apex_tpu_torch.ops import flash_attention as tfa
from apex_tpu_torch.transformer.tensor_parallel import random as trandom


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One CPU thread for the port's plain versions (as the other flash
    tests: once JAX has run in the process, torch's vector math on a
    worker thread sometimes loses precision)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, h, s, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for _ in range(4)]


def _close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want))
    assert err <= 1e-5 * max(1.0, np.max(np.abs(want))), (what, err)


# ------------------------------------------------------- the keep mask ----

@pytest.mark.parametrize("seed", [-2 ** 31, -1, 0, 12345, 2 ** 31 - 1])
@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9999])
@pytest.mark.parametrize("shape,offs", [
    ((2, 3, 17, 33), (0, 0)), ((1, 2, 5, 70), (4096, 0)),
    ((3, 1, 9, 9), (2 ** 31 - 5, 2 ** 30)), ((1, 4, 64, 1), (-3, 77))])
def test_keep_mask_is_the_jax_hash_bit_for_bit(seed, rate, shape, offs):
    b, h, sq, sk = shape
    want = np.asarray(jfa.dropout_keep_dense(
        jnp.int32(seed), b, h, sq, sk, rate, q_off=offs[0], k_off=offs[1]))
    got = tfa.dropout_keep_dense(seed, b, h, sq, sk, rate, *offs)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_keep_share_and_seed_forms():
    """The keep share sits within 5 sigma of 1 - rate over 2^20 scores;
    a tensor seed, an array seed and an int give the same mask, and two
    seeds give different ones."""
    n = 4 * 256 * 1024
    keep = tfa.dropout_keep_dense(7, 1, 4, 256, 1024, 0.3)
    sigma = math.sqrt(0.3 * 0.7 / n)
    assert abs(keep.float().mean().item() - 0.7) < 5 * sigma
    a = tfa.dropout_keep_dense(torch.tensor([[-9]], dtype=torch.int32), 2, 2,
                               8, 8, 0.5)
    b = tfa.dropout_keep_dense(np.array([[-9]], np.int32), 2, 2, 8, 8, 0.5)
    c = tfa.dropout_keep_dense(-9, 2, 2, 8, 8, 0.5)
    assert torch.equal(a, b) and torch.equal(b, c)
    assert not torch.equal(c, tfa.dropout_keep_dense(-8, 2, 2, 8, 8, 0.5))
    assert tfa._seed3(None) == (0, 0, 0)
    assert tfa._seed3(2 ** 31, -1, 2 ** 32 + 5) == (-2 ** 31, -1, 5)


# ------------------------------- the plain flash versions with dropout ----

def _jax_flash(q, k, v, do, *, causal, rate, seed, seg=None, hp=1,
               block=None):
    """o and (dq, dk, dv) of the JAX `_flash` (its Pallas kernels in
    interpret mode) with the int32 seed `seed`."""
    ids = None if seg is None else jnp.asarray(seg)
    scale = 1.0 / math.sqrt(q.shape[-1])
    jseed = jnp.asarray([[seed]], jnp.int32)

    def f(q_, k_, v_):
        return jfa._flash(q_, k_, v_, None, ids, ids, scale, causal,
                          float(rate), block, block, hp, False, jseed)

    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_flash(q, k, v, do, *, causal, rate, seed, seg=None, offs=(0, 0)):
    """o from `flash_fwd_reference` and dq, dk, dv from the backward's
    plain versions on the port's lse, with the seed triple (seed, *offs)."""
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    ids = None if seg is None else torch.tensor(seg)
    scale = 1.0 / math.sqrt(q.shape[-1])
    kw = dict(dropout_rate=rate, seed=(seed, *offs))
    o, lse = tfa.flash_fwd_reference(tq, tk, tv, scale, causal, ids, ids,
                                     **kw)
    delta = torch.sum(tdo * o, dim=-1)
    args = (tq, tk, tv, tdo, lse, delta, scale, causal, ids, ids)
    return o, (tfa.flash_bwd_dq_reference(*args, **kw),
               *tfa.flash_bwd_dkv_reference(*args, **kw))


def _pad_segments(b, s, lengths):
    return (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.int32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_plain_flash_with_dropout_matches_jax_kernels(causal, rate):
    """(1, 2, 128, 64): the JAX fused kernels (one 128-row block) against
    the port's plain forward and backward with the same seed."""
    q, k, v, do = _inputs(1, 2, 128, 64, seed=70 + causal)
    seed = -123456789
    jo, jg = _jax_flash(q, k, v, do, causal=causal, rate=rate, seed=seed)
    to, tg = _port_flash(q, k, v, do, causal=causal, rate=rate, seed=seed)
    _close(to, jo, "o")
    for g, w, what in zip(tg, jg, ("dq", "dk", "dv")):
        _close(g, w, what)
    # the mask did something: rate 0 gives another o
    ro, _ = _port_flash(q, k, v, do, causal=causal, rate=0.0, seed=seed)
    assert not torch.allclose(ro, to)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_flash_dropout_with_segment_ids_matches_jax(causal):
    """BERT's padding as segment ids (128, 70 and 1 real tokens) with
    dropout 0.2, the JAX kernels' `_mask_bias` order."""
    q, k, v, do = _inputs(3, 2, 128, 64, seed=80 + causal)
    seg = _pad_segments(3, 128, [128, 70, 1])
    jo, jg = _jax_flash(q, k, v, do, causal=causal, rate=0.2, seed=99,
                        seg=seg)
    to, tg = _port_flash(q, k, v, do, causal=causal, rate=0.2, seed=99,
                         seg=seg)
    # the JAX kernels' backward differs from attention_reference's on a
    # row whose keys are all masked (ROADMAP Queue 3); these ids leave
    # none: every pad sees the other pads
    _close(to, jo, "o")
    for g, w, what in zip(tg, jg, ("dq", "dk", "dv")):
        _close(g, w, what)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_flash_dropout_matches_jax_packed_kernels(causal):
    """heads_per_step=2 (the JAX `_fwd_kernel_packed` and
    `_bwd_fused_kernel_packed`, 32 x 32 blocks, (2, 4, 64, 16)): the packed
    kernels hash head i * hp + p, the flat head the port's plain version
    uses."""
    q, k, v, do = _inputs(2, 4, 64, 16, seed=90 + causal)
    jo, jg = _jax_flash(q, k, v, do, causal=causal, rate=0.3, seed=42,
                        hp=2, block=32)
    to, tg = _port_flash(q, k, v, do, causal=causal, rate=0.3, seed=42)
    _close(to, jo, "o")
    for g, w, what in zip(tg, jg, ("dq", "dk", "dv")):
        _close(g, w, what)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_split_backward_with_dropout_matches_jax(monkeypatch, causal):
    """The split route (the JAX `_bwd_dq_kernel` and `_bwd_dkv_kernel`,
    forced by shrinking `_FUSED_BWD_CAP` to 1; 64 x 64 blocks) at
    (1, 2, 256, 64), dropout 0.25, against the port's plain dq and dk/dv
    on the JAX forward's lse."""
    monkeypatch.setattr(jfa, "_FUSED_BWD_CAP", 1)
    q, k, v, do = _inputs(1, 2, 256, 64, seed=100 + causal)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(64)
    seed = 2 ** 31 - 1
    o, lse = jfa._fwd_impl(jq, jk, jv, scale, causal, 0.25,
                           jnp.asarray([[seed]], jnp.int32), 64, 64)
    want = jfa._bwd_impl(jq, jk, jv, o, lse, jdo, scale, causal, 0.25,
                         jnp.asarray([[seed]], jnp.int32), 64, 64)[:3]
    delta = jnp.sum(jdo * o, -1)
    to, tlse = tfa.flash_fwd_reference(
        *(torch.tensor(x) for x in (q, k, v)), scale, causal,
        dropout_rate=0.25, seed=(seed, 0, 0))
    _close(to, o, "o")
    _close(tlse, lse, "lse")
    args = (*(torch.tensor(x) for x in (q, k, v, do)),
            torch.tensor(np.asarray(lse)), torch.tensor(np.asarray(delta)),
            scale, causal)
    kw = dict(dropout_rate=0.25, seed=(seed, 0, 0))
    got = (tfa.flash_bwd_dq_reference(*args, **kw),
           *tfa.flash_bwd_dkv_reference(*args, **kw))
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        _close(g, w, what)


def test_plain_flash_dropout_offsets_match_jax():
    """A chunk of a longer sequence: q_off 4096, k_off 64 shift the hash's
    rows and keys, forward and backward, against the JAX `_fwd_impl` /
    `_bwd_impl` with the same offsets (non-causal, (1, 2, 128, 64))."""
    q, k, v, do = _inputs(1, 2, 128, 64, seed=110)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(64)
    jseed = jnp.asarray([[5]], jnp.int32)
    o, lse = jfa._fwd_impl(jq, jk, jv, scale, False, 0.5, jseed,
                           q_off=4096, k_off=64)
    want = jfa._bwd_impl(jq, jk, jv, o, lse, jdo, scale, False, 0.5, jseed,
                         q_off=4096, k_off=64)[:3]
    to, tg = _port_flash(q, k, v, do, causal=False, rate=0.5, seed=5,
                         offs=(4096, 64))
    _close(to, o, "o")
    for g, w, what in zip(tg, want, ("dq", "dk", "dv")):
        _close(g, w, what)
    no_off, _ = _port_flash(q, k, v, do, causal=False, rate=0.5, seed=5)
    assert not torch.allclose(no_off, to)


def test_plain_forward_gradient_is_the_plain_backward():
    """Autograd through `flash_fwd_reference` with dropout gives the
    backward's plain versions' dq, dk, dv (fp32, 1e-5)."""
    q, k, v, do = (torch.tensor(x) for x in _inputs(2, 2, 96, 64, seed=120))
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    kw = dict(dropout_rate=0.3, seed=(11, 0, 0))
    o, lse = tfa.flash_fwd_reference(qr, kr, vr, 0.125, True, **kw)
    o.backward(do)
    delta = torch.sum(do * o.detach(), -1)
    args = (q, k, v, do, lse.detach(), delta, 0.125, True)
    for got, want in ((qr.grad, tfa.flash_bwd_dq_reference(*args, **kw)),
                      *zip((kr.grad, vr.grad),
                           tfa.flash_bwd_dkv_reference(*args, **kw))):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# ------------------------------------------------------ _common.dropout ----

def test_common_dropout_is_the_jax_contract():
    x = torch.randn(64, 1024, generator=torch.Generator().manual_seed(0))
    assert _common.dropout(None, 0.5, x) is x
    assert _common.dropout(torch.Generator().manual_seed(1), 0.0, x) is x
    y = _common.dropout(torch.Generator().manual_seed(1), 0.25, x)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75, atol=0, rtol=0)
    n, p = x.numel(), 0.75
    assert abs(kept.float().mean().item() - p) < 5 * math.sqrt(
        p * (1 - p) / n)
    again = _common.dropout(torch.Generator().manual_seed(1), 0.25, x)
    assert torch.equal(again, y)
    bf = x.to(torch.bfloat16)
    yb = _common.dropout(torch.Generator().manual_seed(1), 0.25, bf)
    assert yb.dtype == torch.bfloat16
    # the JAX package's `x / keep` in x's dtype
    assert torch.equal(yb[kept], bf[kept] / 0.75)


def test_host_seed_takes_cpu_keys_only():
    g = torch.Generator().manual_seed(3)
    s = _common.host_seed(g)
    assert -2 ** 31 <= s < 2 ** 31 - 1
    assert s == _common.host_seed(torch.Generator().manual_seed(3))
    # a generator on the card (a stand-in: this host has none)
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        _common.host_seed(types.SimpleNamespace(device=torch.device("cuda")))


def test_cpu_flash_attention_drops_as_the_reference():
    """On the CPU `flash_attention` with dropout is `attention_reference`
    with `_common.dropout`'s draw: the same key state, the same output;
    another key, another."""
    q, k, v, _ = (torch.tensor(x) for x in _inputs(1, 2, 32, 64, seed=130))
    a = tfa.flash_attention(q, k, v, causal=True, dropout_rate=0.4,
                            dropout_key=torch.Generator().manual_seed(8))
    b = tfa.attention_reference(q, k, v, causal=True, dropout_rate=0.4,
                                dropout_key=torch.Generator().manual_seed(8))
    c = tfa.flash_attention(q, k, v, causal=True, dropout_rate=0.4,
                            dropout_key=torch.Generator().manual_seed(9))
    assert torch.equal(a, b) and not torch.equal(a, c)


# ------------------------------------------ tensor_parallel.random ----

def test_tracker_messages_and_seeds_are_jax_s():
    jt, tt = jrandom.RNGStatesTracker(), trandom.RNGStatesTracker()
    jt.add("a", 1)
    tt.add("a", 1)
    for tracker, mod in ((jt, "jax"), (tt, "torch")):
        with pytest.raises(Exception) as err:
            tracker.add("a", 2)
        assert str(err.value) == "rng state a already exists", mod
        with pytest.raises(Exception) as err:
            tracker.fork("nope")
        assert str(err.value) == "rng state nope is not added", mod
    t = trandom.model_parallel_seed(1234, trandom.RNGStatesTracker())
    assert sorted(t.get_states()) == ["default", "model-parallel-rng"]
    j = jrandom.model_parallel_seed(1234, jrandom.RNGStatesTracker())
    assert sorted(j.get_states()) == sorted(t.get_states())
    assert t.get_states()["default"].initial_seed() == 1234
    assert t.get_states()["model-parallel-rng"].initial_seed() == 1234 + 2718
    assert trandom.get_rng_tracker() is trandom.get_rng_tracker()
    # fork: a fresh key, and the named state moves on
    before = t.get_states()["model-parallel-rng"].get_state()
    sub = t.fork()
    assert isinstance(sub, torch.Generator)
    assert not torch.equal(t.get_states()["model-parallel-rng"].get_state(),
                           before)
    saved = t.get_states()
    t.reset()
    assert t.get_states() == {}
    t.set_states(saved)
    assert t.get_states() == saved


def test_fold_in_and_split_are_pure():
    """Derived keys depend on the key's state and the data only, and
    never advance the key: the property remat relies on."""
    key = torch.Generator().manual_seed(5)
    state = key.get_state()
    a = trandom.fold_in(key, 3)
    b = trandom.fold_in(key, 3)
    assert torch.equal(key.get_state(), state)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    draws = [torch.rand(4, generator=g) for g in trandom.split(key, 3)]
    assert not torch.equal(draws[0], draws[1])
    assert torch.equal(draws[2], torch.rand(
        4, generator=trandom.split(key, 3)[2]))
    assert not torch.equal(torch.rand(4, generator=trandom.fold_in(key, 4)),
                           torch.rand(4, generator=trandom.fold_in(key, 3)))
    mp = trandom.model_parallel_fold_in(key)
    assert torch.equal(mp.get_state(), trandom.fold_in(key, 2718).get_state())
    torch.rand(1, generator=key)          # a draw moves the key on
    assert not torch.equal(torch.rand(4, generator=trandom.fold_in(key, 3)),
                           torch.rand(4, generator=trandom.fold_in(
                               torch.Generator().manual_seed(5), 3)))


def test_one_rank_storage_round_trips_and_more_raise():
    """Without a tp group the distributed storage keeps all of x and
    round-trips it, and so it does over "pp" and "ep" without a mesh; the
    tp storage over more ranks runs over the tp group
    (tests/test_torch_tensor_parallel.py), and an axis with no group
    raises."""
    x = torch.randn(3, 4, 5)
    chunk = trandom.split_tensor_into_1d_equal_chunks(x)
    assert torch.equal(trandom.gather_split_1d_tensor(chunk).reshape(x.shape),
                       x)
    for axis in ("pp", "ep"):
        assert torch.equal(trandom.split_tensor_into_1d_equal_chunks(x, axis),
                           chunk)
    for fn, args in ((trandom.split_tensor_into_1d_equal_chunks, (x, "cp")),
                     (trandom.gather_split_1d_tensor, (chunk, "cp")),
                     (trandom.checkpoint_with_distributed_saved_activations(
                         torch.sin, "cp"), (x,))):
        with pytest.raises(ValueError, match="no process group"):
            fn(*args)
    assert trandom.init_checkpointed_activations_memory_buffer() is None


def test_checkpoint_recomputes_with_the_same_grads():
    """`checkpoint` (full and with a selective policy) and the one-rank
    distributed storage give autograd's gradient bit for bit, dropout
    from a key derived inside the checkpointed function included."""
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(2))
    w = torch.randn(16, 16, generator=torch.Generator().manual_seed(3))
    key = torch.Generator().manual_seed(4)

    def fn(x_, w_):
        k1, = trandom.split(key, 1)
        return _common.dropout(k1, 0.5, torch.tanh(x_ @ w_)).sum()

    def grads(run):
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        run(xr, wr).backward()
        return xr.grad, wr.grad

    want = grads(fn)
    mm = [torch.ops.aten.mm.default]
    for run in (lambda a, b: trandom.checkpoint(fn, a, b),
                lambda a, b: trandom.checkpoint(fn, a, b, policy=mm),
                trandom.checkpoint_with_distributed_saved_activations(fn)):
        for got, w_ in zip(grads(run), want):
            assert torch.equal(got, w_)
