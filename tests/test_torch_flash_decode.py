"""The PyTorch port's paged flash-decode (apex_tpu_torch.ops.flash_decode)
against the JAX package's, on the CPU.

The JAX side runs its Pallas decode kernel in interpret mode
(`use_pallas_override=True`, as tests/test_serve.py does); the port's
side runs its plain PyTorch version, which is what CPU tensors get.
Both read the same paged cache, built by tests/test_serve.py's
shuffled-page construction.  Tolerance: fp32 atol 2e-5 / rtol 1e-5
(two fp32 softmax attentions summing in different orders); rows with no
visible position exactly 0."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from apex_tpu_torch.ops import flash_decode as tfd
from test_serve import _paged_case


def _torch(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("q_len", [1, 2])
@pytest.mark.parametrize("G", [1, 2])
def test_decode_matches_jax_pallas(q_len, G):
    rng = np.random.RandomState(1)
    ns, hkv, d, page, maxp = 4, 2, 16, 8, 4
    hq = G * hkv
    lengths = [0, 5, page * 2, maxp * page]
    _, _, k_pages, v_pages, tbl, lens = _paged_case(
        rng, ns, hq, hkv, d, page, maxp, lengths)
    q = jnp.asarray(rng.randn(ns, q_len, hq, d).astype(np.float32))
    want = np.asarray(jax_flash_decode(q, k_pages, v_pages, tbl, lens,
                                       use_pallas_override=True))
    tq, tk, tv, tt, tl_ = _torch(q, k_pages, v_pages, tbl, lens)
    before = tfd.flash_decode_cuda.launches
    got = tfd.flash_decode(tq, tk, tv, tt, tl_)
    ref = tfd.paged_attention_reference(tq, tk, tv, tt, tl_)
    assert tfd.flash_decode_cuda.launches == before   # CPU: plain version
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)
    # inactive slot, and (q_len > 1) rows before the sequence start
    vis = (np.asarray(lengths)[:, None] - q_len + 1
           + np.arange(q_len)[None, :])
    assert np.all(got.numpy()[vis <= 0] == 0)
    assert np.all(got.numpy()[0] == 0)


def test_decode_bf16_matches_jax_reference():
    """bf16 cache: the port's plain version equals the JAX package's
    plain version (both fp32 softmax, one final round to bf16) within
    one bf16 rounding."""
    rng = np.random.RandomState(2)
    ns, hkv, d, page, maxp = 3, 2, 16, 8, 3
    _, _, k_pages, v_pages, tbl, lens = _paged_case(
        rng, ns, hkv, hkv, d, page, maxp, [7, 0, 24])
    q = rng.randn(ns, 1, hkv, d).astype(np.float32)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k_pages, v_pages)]
    want = np.asarray(jax_flash_decode(*jb, tbl, lens, use_pallas_override=False)
                      .astype(jnp.float32))
    tb = [torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
          for a in (q, k_pages, v_pages)]
    got = tfd.flash_decode(*tb, *_torch(tbl, lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=1e-2)
    assert np.all(got.float().numpy()[1] == 0)


def _bad_cases():
    rng = np.random.RandomState(0)
    q = rng.randn(3, 1, 4, 8).astype(np.float32)
    kp = rng.randn(2, 5, 4, 8).astype(np.float32)
    tbl = np.zeros((3, 2), np.int32)
    lens = np.zeros((3,), np.int32)
    return {
        "q_ndim": (q[0], kp, kp, tbl, lens),
        "pages_mismatch": (q, kp, kp[:, :4], tbl, lens),
        "head_dim": (q[..., :4], kp, kp, tbl, lens),
        "gqa_groups": (q[:, :, :3], kp, kp, tbl, lens),
        "table_rows": (q, kp, kp, tbl[:2], lens),
        "lengths": (q, kp, kp, tbl, lens[:2]),
        "q_len_capacity": (np.repeat(q, 9, axis=1), kp, kp, tbl, lens),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_bad_shapes_raise_the_same_errors(case):
    args = _bad_cases()[case]
    with pytest.raises(ValueError) as jerr:
        jax_flash_decode(*[jnp.asarray(a) for a in args])
    with pytest.raises(ValueError) as terr:
        tfd.flash_decode(*_torch(*args))
    assert str(terr.value) == str(jerr.value)


def test_heads_per_step_validated_like_jax():
    """heads_per_step keeps the JAX package's validation: None → the
    power-of-two heuristic (the TPU's; the card's plan states its own),
    a non-divisor warns and degrades to 1."""
    assert tfd._resolve_heads_per_step(None, 16, 128) == 8
    assert tfd._resolve_heads_per_step(None, 16, 64) == 16
    assert tfd._resolve_heads_per_step(2, 16, 128) == 2
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert tfd._resolve_heads_per_step(3, 16, 128) == 1
    assert any("does not divide" in str(x.message) for x in w)


# ------------------------------ the CUDA plan -------------------------------

_H100_SMS = 132


def _pages_of(plan, max_pages):
    """The page runs of a slot's split ranks (the kernel's pps)."""
    pps = -(-max_pages // plan.split)
    return [list(range(r * pps, min((r + 1) * pps, max_pages)))
            for r in range(plan.split)]


@pytest.mark.parametrize("args", [
    (64, 16, 1, 1, 2, 128, 64, 2),      # serving (GPT-350M, 64 slots)
    (4, 16, 1, 1, 32, 128, 64, 2),      # 4 slots x 4096 keys
    (1, 16, 1, 1, 512, 16, 128, 4),     # one slot, small pages
    (4, 2, 2, 2, 4, 16, 128, 4),        # GQA, a query block of 2
    (5, 2, 8, 2, 5, 8, 64, 4),          # 16 query rows a kv head
    (64, 8, 4, 1, 16, 64, 128, 2),      # GQA decode, 1024 keys
])
def test_decode_plan(args):
    """`decode_plan`: the row tile is 1 exactly when a kv head has one
    query row; the heads a block divide hkv (the rule's: the largest
    power of two that leaves DECODE_BLOCKS_PER_SM blocks an SM, or 1);
    a split (at most 8, a cluster) only when the blocks leave SMs idle
    and a slot has more than one page, and its ranks' page runs cover
    every page of a slot exactly once; the ring holds at least one chunk
    and at most all of a block's; a block's shared memory fits its share
    (227 KB at most)."""
    n_slots, hkv, G, q_len, max_pages, page, d, el = args
    plan = tfd.decode_plan(*args, _H100_SMS)
    rows = G * q_len
    assert plan.row_tile == (1 if rows == 1 else 8)
    tiles = -(-rows // plan.row_tile)
    hp = plan.heads_per_block
    assert hkv % hp == 0 and hp & (hp - 1) == 0
    blocks = n_slots * (hkv // hp) * tiles
    if hp > 1:
        assert blocks >= tfd.DECODE_BLOCKS_PER_SM * _H100_SMS
    elif hkv % 2 == 0:
        assert (n_slots * (hkv // 2) * tiles
                < tfd.DECODE_BLOCKS_PER_SM * _H100_SMS)
    assert 1 <= plan.split <= tfd.DECODE_MAX_SPLIT
    if plan.split > 1:
        assert blocks < _H100_SMS and max_pages > 1
        assert blocks * plan.split <= _H100_SMS
    runs = _pages_of(plan, max_pages)
    assert sorted(p for run in runs for p in run) == list(range(max_pages))
    assert all(runs)        # no rank without a page of a full slot
    chunk = min(page, tfd.DECODE_CHUNK)
    items = hp * -(-max_pages // plan.split) * -(-page // chunk)
    assert 1 <= plan.stages <= items
    assert plan.chunk == min(page, tfd.DECODE_CHUNK) and plan.chunk % 8 == 0
    smem = tfd.decode_smem(d, el, plan.row_tile, hp, plan.split,
                           plan.stages, plan.chunk, max_pages)
    share = (tfd.DECODE_SMEM_ALONE if blocks * plan.split <= _H100_SMS
             else tfd.DECODE_SMEM_SHARED)
    assert smem <= share or plan.stages == 1
    assert smem <= 227 * 1024


def test_decode_plan_at_serving_and_long_context():
    """Serving's shape takes no split; 4 slots x 4096 keys (32 pages of
    128) take a split of at most 8 whose page runs cover each slot once;
    the caller's heads_per_step is the plan's heads a block."""
    serve = tfd.decode_plan(64, 16, 1, 1, 2, 128, 64, 2, _H100_SMS)
    assert serve.split == 1 and serve.row_tile == 1
    long = tfd.decode_plan(4, 16, 1, 1, 32, 128, 64, 2, _H100_SMS)
    assert 1 < long.split <= 8
    assert sorted(sum(_pages_of(long, 32), [])) == list(range(32))
    for hp in (1, 2, 4, 8):
        assert tfd.decode_plan(64, 16, 1, 1, 2, 128, 64, 2, _H100_SMS,
                               hp).heads_per_block == hp
    with pytest.raises(ValueError, match="does not divide"):
        tfd.decode_plan(64, 16, 1, 1, 2, 128, 64, 2, _H100_SMS, 3)


@pytest.fixture
def decode_stand_in(tmp_path, monkeypatch):
    """Stand-ins for the card (on the CPU): the kernel device check says
    CUDA, the C launch (`_launch`) records its plan and fills out with the
    plain version; the tuner reads a fresh cache file."""
    from apex_tpu_torch import tune

    monkeypatch.setenv(tune.ENV_CACHE_PATH, str(tmp_path / "tune.json"))
    monkeypatch.delenv(tune.ENV_DISABLE, raising=False)
    tune.invalidate()
    monkeypatch.setattr(tfd, "_HP_FALLBACK_WARNED", set())
    plans = []

    def launch(plan, q, k_pages, v_pages, tbl, lens, out, scale):
        plans.append(plan)
        assert tbl.dtype == lens.dtype == torch.int32
        assert out.shape == q.shape and out.dtype == q.dtype
        out.copy_(tfd.paged_attention_reference(
            q, k_pages, v_pages, tbl, lens, softmax_scale=scale))

    monkeypatch.setattr(tfd, "_launch", launch)
    monkeypatch.setattr(tfd, "_sm_count", lambda device: _H100_SMS)
    monkeypatch.setattr(tfd, "check_kernel_device", lambda *t: True)
    yield plans
    tune.invalidate()


@pytest.mark.parametrize("hp", [None, 1, 2])
@pytest.mark.parametrize("q_len,G", [(1, 1), (2, 2)])
def test_decode_launcher_matches_jax_decode_pallas(q_len, G, hp,
                                                   decode_stand_in):
    """`flash_decode` on the kernel route with a recording stand-in for
    the C launch: one launch under `decode_plan` (the caller's
    heads_per_step reaching it), and the output matches the JAX
    package's `_decode_pallas` (its Pallas kernel in interpret mode) at
    the same heads_per_step; fp32 atol 2e-5 / rtol 1e-5, rows with no
    visible position exactly 0."""
    from apex_tpu.ops.flash_decode import _decode_pallas

    rng = np.random.RandomState(3)
    ns, hkv, d, page, maxp = 4, 2, 64, 8, 4
    lengths = [0, 5, page * 2, maxp * page]
    _, _, k_pages, v_pages, tbl, lens = _paged_case(
        rng, ns, G * hkv, hkv, d, page, maxp, lengths)
    q = jnp.asarray(rng.randn(ns, q_len, G * hkv, d).astype(np.float32))
    want = np.asarray(_decode_pallas(q, k_pages, v_pages, tbl, lens,
                                     1.0 / 8.0, hp or 1))
    tq, tk, tv, tt, tl_ = _torch(q, k_pages, v_pages, tbl, lens)
    got = tfd.flash_decode(tq, tk, tv, tt, tl_, heads_per_step=hp)
    assert decode_stand_in == [tfd.decode_plan(
        ns, hkv, G, q_len, maxp, page, d, 4, _H100_SMS, hp)]
    assert decode_stand_in[0].heads_per_block == (hp or 1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)
    vis = (np.asarray(lengths)[:, None] - q_len + 1
           + np.arange(q_len)[None, :])
    assert np.all(got.numpy()[vis <= 0] == 0)


def test_tuned_heads_per_step_reaches_the_plan(decode_stand_in):
    """A tuner entry's heads_per_step (no caller knob) is the plan's
    heads a block; an invalid caller knob warns and runs unpacked, as in
    the JAX package."""
    from apex_tpu_torch import tune

    q = torch.zeros(4, 1, 4, 64)
    pages = torch.zeros(4, 9, 16, 64)
    tbl = torch.ones(4, 2, dtype=torch.int32)
    lens = torch.tensor([0, 3, 16, 20], dtype=torch.int32)
    tune.record("flash_decode", tune.decode_attrs(4, 1, 4, 4, 64, 16,
                                                  torch.float32),
                {"heads_per_step": 2})
    tfd.flash_decode(q, pages, pages, tbl, lens)
    assert decode_stand_in[-1].heads_per_block == 2
    with pytest.warns(UserWarning, match="does not divide"):
        tfd.flash_decode(q, pages, pages, tbl, lens, heads_per_step=3)
    assert decode_stand_in[-1].heads_per_block == 1
    tfd.flash_decode(q, pages, pages, tbl, lens, heads_per_step=4)
    assert decode_stand_in[-1].heads_per_block == 4
