"""The PyTorch port's paged KV cache (apex_tpu_torch.serve.kv_cache):
allocator accounting, the trash page, double-release detection, pricing
equal to the JAX package's KVCacheConfig, and snapshots."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.serve import KVCacheConfig as JKVCacheConfig
from apex_tpu.serve import gather_slot as jax_gather_slot
from apex_tpu_torch.serve import (TRASH_PAGE, KVCacheConfig,
                                  PageAccountingError, PagedKVCache,
                                  default_page_size, gather_slot)


def _cfg(**kw):
    base = dict(n_layers=2, n_kv_heads=2, head_dim=8, n_slots=3, n_pages=7,
                pages_per_slot_max=3, page_size=4, dtype=torch.float32)
    base.update(kw)
    return KVCacheConfig(**base)


def test_allocator_accounting_and_trash_page():
    cache = PagedKVCache(_cfg(), device="cpu")
    assert cache.free_pages == 6
    assert cache.can_admit(12) and not cache.can_admit(13)
    row = cache.allocate_slot(0, 9)              # 3 pages
    assert row is not None and TRASH_PAGE not in row.tolist()
    assert cache.free_pages == 3
    assert cache.allocate_slot(1, 13) is None    # 4 pages > per-slot max
    row1 = cache.allocate_slot(1, 12)            # the last 3 pages
    assert cache.free_pages == 0 and cache.allocate_slot(2, 1) is None
    held = cache.slot_pages(0) + cache.slot_pages(1)
    assert sorted(held) == list(range(1, 7))     # never the trash page
    assert list(row1) == cache.slot_pages(1)
    table = cache.device_table()
    assert table.dtype == torch.int32 and table.shape == (3, 3)
    assert table[2].tolist() == [TRASH_PAGE] * 3
    cache.release_slot(0)
    assert cache.free_pages == 3
    assert table[0].tolist() == list(row)        # the table was a copy
    with pytest.raises(ValueError, match="already holds pages"):
        cache.allocate_slot(1, 1)


def test_double_release_raises_by_name():
    cache = PagedKVCache(_cfg(), device="cpu")
    cache.allocate_slot(2, 3)
    cache.release_slot(2)
    with pytest.raises(PageAccountingError, match="double"):
        cache.release_slot(2)
    with pytest.raises(PageAccountingError):
        cache.release_slot(0)                    # never allocated
    assert cache.free_pages == 6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pricing_equals_jax(dtype):
    kw = dict(n_layers=24, n_kv_heads=16, head_dim=64, n_slots=64,
              n_pages=65, pages_per_slot_max=2, page_size=128)
    t = KVCacheConfig(dtype=getattr(torch, dtype), **kw)
    j = JKVCacheConfig(dtype=getattr(jnp, dtype), **kw)
    for name in ("page_bytes", "pool_bytes", "bytes_per_token"):
        assert getattr(t, name)() == getattr(j, name)(), name
    for n in (0, 1, 127, 128, 129, 256):
        assert t.bytes_per_user(n) == j.bytes_per_user(n)
        assert t.pages_for(n) == j.pages_for(n)
    assert (t.usable_pages, t.max_seq_len) == (j.usable_pages, j.max_seq_len)
    auto = KVCacheConfig(**{**kw, "page_size": None})
    assert auto.page_size == default_page_size(16, 64) == 128


def test_config_validation():
    with pytest.raises(ValueError, match="trash page"):
        _cfg(n_pages=1)
    with pytest.raises(ValueError, match=">= 1"):
        _cfg(n_slots=0)


def test_state_dict_roundtrip_and_validation():
    cache = PagedKVCache(_cfg(), device="cpu")
    cache.allocate_slot(0, 5)
    cache.allocate_slot(2, 4)
    snap = cache.state_dict()
    fresh = PagedKVCache(_cfg(), device="cpu")
    fresh.load_state_dict(snap)
    assert fresh.free_pages == cache.free_pages
    assert fresh.slot_pages(0) == cache.slot_pages(0)
    assert torch.equal(fresh.device_table(), cache.device_table())
    fresh.release_slot(0)                        # the restored accounting
    assert fresh.free_pages == cache.free_pages + 2
    bad = dict(snap, free=snap["free"][:-1])     # a page lost
    with pytest.raises(ValueError, match="accounts for"):
        PagedKVCache(_cfg(), device="cpu").load_state_dict(bad)
    with pytest.raises(ValueError, match="table shape"):
        PagedKVCache(_cfg(n_slots=4), device="cpu").load_state_dict(snap)


def test_pool_layout_and_gather_slot_match_jax():
    cfg = _cfg()
    cache = PagedKVCache(cfg, device="cpu")
    k, v = cache.init_pages()
    assert tuple(k.shape) == (2, 2, 7, 4, 8) and k.dtype == torch.float32
    assert not k.any() and k.data_ptr() != v.data_ptr()
    rng = np.random.RandomState(0)
    kp = rng.randn(*k.shape).astype(np.float32)
    vp = rng.randn(*k.shape).astype(np.float32)
    row = cache.allocate_slot(1, 10)
    for layer in (0, 1):
        tk, tv = gather_slot(torch.tensor(kp), torch.tensor(vp), row, 10,
                             layer=layer)
        jk, jv = jax_gather_slot(jnp.asarray(kp), jnp.asarray(vp), row, 10,
                                 layer=layer)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_cache_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedKVCache(_cfg())
