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
    """heads_per_step keeps the JAX package's validation (the Hopper
    kernel does not use it yet): None → the power-of-two heuristic, a
    non-divisor warns and degrades to 1."""
    assert tfd._resolve_heads_per_step(None, 16, 128) == 8
    assert tfd._resolve_heads_per_step(None, 16, 64) == 16
    assert tfd._resolve_heads_per_step(2, 16, 128) == 2
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert tfd._resolve_heads_per_step(3, 16, 128) == 1
    assert any("does not divide" in str(x.message) for x in w)
