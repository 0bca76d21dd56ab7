"""The PyTorch port's tuner (apex_tpu_torch.tune) against the JAX
package's (apex_tpu.tune), on the CPU: the cache file, the key strings,
the committed defaults, the flash and decode lookups and their
validation, the packed backward's route, and the offline sweep.  One
cache file serves both packages, so most tests write it with one and
read it with the other.  Exact comparisons throughout: keys, configs and
routes are strings and integers."""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import tune as jtune
from apex_tpu.ops import flash_attention as jfa
from apex_tpu.ops import flash_decode as jfd
from apex_tpu.tune import defaults as jdefaults
from apex_tpu.tune import search as jsearch
from apex_tpu_torch import tune
from apex_tpu_torch.ops import flash_attention as tfa
from apex_tpu_torch.ops import flash_decode as tfd
from apex_tpu_torch.serve import kv_cache as tkv
from apex_tpu_torch.tune import defaults, search


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    """A fresh cache file for both packages, empty memos and counters,
    and fresh warn-once sets."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv(tune.ENV_CACHE_PATH, str(path))
    monkeypatch.delenv(tune.ENV_DISABLE, raising=False)
    for mod in (tune, jtune):
        mod.invalidate()
        mod.reset_stats()
    monkeypatch.setattr(tune.cache, "_state",
                        dict(tune.cache._state, warned=set()))
    for mod in (tfa, jfa):
        monkeypatch.setattr(mod, "_BLOCK_FALLBACK_WARNED", set())
    for mod in (tfd, jfd):
        monkeypatch.setattr(mod, "_HP_FALLBACK_WARNED", set())
    yield path
    for mod in (tune, jtune):
        mod.invalidate()
        mod.reset_stats()


_ATTRS = dict(b=2, h=4, sq=64, sk=64, d=16, dtype="float32", causal=True,
              bias="none", seg=False)


# ------------------------------- cache layer --------------------------------

def test_cache_round_trip(tmp_cache):
    cfg = {"block_q": 64, "block_k": 64, "heads_per_step": 2}
    key = tune.record("flash_sdpa", _ATTRS, cfg, meta={"ms": 1.0})
    assert key == jtune.make_key("flash_sdpa", _ATTRS)
    tune.invalidate()
    assert tune.tuned("flash_sdpa", _ATTRS) == cfg
    raw = json.loads(tmp_cache.read_text())
    assert raw["schema"] == tune.SCHEMA_VERSION == jtune.SCHEMA_VERSION
    assert raw["entries"]["cpu"][key]["meta"] == {"ms": 1.0}
    assert tune.stats()["hits"] == 1


def test_missing_cache_is_a_miss_without_warning(tmp_cache):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tune.tuned("flash_sdpa", _ATTRS) is None
        assert tune.tuned("flash_sdpa", _ATTRS) is None
    s = tune.stats()
    assert (s["hits"], s["misses"], s["fingerprint"]) == (0, 2, "empty")


@pytest.mark.parametrize("text,match", [
    ("{ not json !!!", "corrupt"),
    (json.dumps({"schema": 99, "entries": {}}), "schema"),
    (json.dumps([1, 2]), "schema")])
def test_bad_cache_file_warns_once_and_is_empty(tmp_cache, text, match):
    tmp_cache.write_text(text)
    with pytest.warns(UserWarning, match=match):
        assert tune.tuned("flash_sdpa", _ATTRS) is None
    tune.invalidate()
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # warned once already
        assert tune.tuned("flash_sdpa", _ATTRS) is None


def test_device_kind_isolation(tmp_cache):
    """Entries of another kind are never read: the port on the CPU is
    "cpu", an H100 is "h100", and no card's name becomes a TPU kind."""
    assert tune.device_kind() == "cpu" == jtune.device_kind()
    cfg = {"block_q": 64, "block_k": 64, "heads_per_step": 2}
    for kind in ("v5e", "h100"):
        tune.record("flash_sdpa", _ATTRS, cfg, kind=kind)
    assert tune.tuned("flash_sdpa", _ATTRS) is None
    assert tune.canonical_kind("NVIDIA H100 80GB HBM3") == "h100"
    assert tune.canonical_kind("NVIDIA H100 PCIe") == "h100"
    assert tune.canonical_kind("Some Card") == "some-card"
    for name in ("v5e", "V5E", "v4", "v6e"):
        assert tune.canonical_kind(name).startswith("gpu-")


def test_disable_switch(tmp_cache, monkeypatch):
    tune.record("flash_sdpa", _ATTRS, {"heads_per_step": 2})
    monkeypatch.setenv(tune.ENV_DISABLE, "0")
    assert tune.tuned("flash_sdpa", _ATTRS) is None
    monkeypatch.setenv(tune.ENV_DISABLE, "1")
    assert tune.tuned("flash_sdpa", _ATTRS) == {"heads_per_step": 2}


def test_fingerprint_is_the_jax_packages(tmp_cache):
    """"empty" with no entry; with entries a 12-hex digest that the JAX
    package computes from the same file; it moves when an entry does."""
    assert tune.fingerprint() == jtune.fingerprint() == "empty"
    tune.record("flash_sdpa", _ATTRS, {"heads_per_step": 2})
    jtune.invalidate()
    fp = tune.fingerprint()
    assert len(fp) == 12 and int(fp, 16) >= 0
    assert fp == jtune.fingerprint()
    tune.record("flash_sdpa", _ATTRS, {"heads_per_step": 4})
    assert tune.fingerprint() != fp


def test_a_file_written_by_either_package_is_read_by_the_other(tmp_cache):
    jtune.record("flash_sdpa", _ATTRS, {"heads_per_step": 2},
                 meta={"ms": 2.0})
    tune.invalidate()
    assert tune.tuned("flash_sdpa", _ATTRS) == {"heads_per_step": 2}
    attrs = tune.serve_page_attrs(16, 64, torch.bfloat16)
    tune.record("serve_page", attrs, {"page_size": 64})
    jtune.invalidate()
    assert jtune.tuned("serve_page",
                       jtune.serve_page_attrs(16, 64, jnp.bfloat16)) == {
        "page_size": 64}
    # both entries survive both writers
    assert tune.tuned("flash_sdpa", _ATTRS) == {"heads_per_step": 2}


# ------------------------------ key functions -------------------------------

@pytest.mark.parametrize("tdt,jdt", [
    (torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32),
    (torch.float16, jnp.float16), (None, None)])
def test_keys_equal_the_jax_packages(tdt, jdt):
    assert tune.dtype_name(tdt) != "torch.bfloat16"
    args = (8, 16, 2048, 2048, 64)
    for causal, bias, seg in ((True, "none", False), (False, "sk", True)):
        assert tune.make_key("flash_sdpa", tune.flash_attrs(
            *args, tdt, causal, bias=bias, seg=seg)) == jtune.make_key(
            "flash_sdpa", jtune.flash_attrs(*args, jdt, causal, bias=bias,
                                            seg=seg))
    assert tune.decode_attrs(64, 1, 16, 16, 64, 128, tdt) == \
        jtune.decode_attrs(64, 1, 16, 16, 64, 128, jdt)
    assert tune.decode_attrs(37, 2, 8, 2, 128, 16, tdt) == \
        jtune.decode_attrs(37, 2, 8, 2, 128, 16, jdt)
    assert tune.serve_page_attrs(16, 64, tdt) == \
        jtune.serve_page_attrs(16, 64, jdt)
    assert tune.moe_router_attrs(3000, 8, 2, tdt) == \
        jtune.moe_router_attrs(3000, 8, 2, jdt)
    assert tune.overlap_attrs("tp_col", 5000, 4096, 4, tdt) == \
        jtune.overlap_attrs("tp_col", 5000, 4096, 4, jdt)
    for n in (0, 1, 2, 3, 1000, 1024, 1025):
        assert tune.pow2_bucket(n) == jtune.pow2_bucket(n)


def test_search_attrs_and_defaults_match_jax():
    assert search.flash_attrs(8, 16, 2048, 64, torch.bfloat16, True) == \
        jsearch.flash_attrs(8, 16, 2048, 64, jnp.bfloat16, True)
    assert defaults.DEFAULTS["v5e"] == jdefaults.DEFAULTS["v5e"]


def test_h100_defaults_hold_only_measured_bench_shape_winners():
    """Only the attention bench shapes (never a model step's), each with
    the ms the sweep measured and the card's name and power limit."""
    bench = {tune.make_key("flash_sdpa", tune.flash_attrs(
        *shape, torch.bfloat16, True)) for shape in (
        (8, 16, 2048, 2048, 64), (1, 8, 32768, 32768, 64),
        (4, 32, 2048, 2048, 64))}
    for key, entry in defaults.DEFAULTS["h100"].items():
        assert key in bench, key
        assert entry["config"]["block_q"] == entry["config"]["block_k"] == 64
        assert entry["config"]["heads_per_step"] > 1
        for field in ("ms", "device", "power_limit"):
            assert field in entry["meta"], (key, field)


# ------------------------- flash attention lookup ---------------------------

_CFGS = [
    {"block_q": 64, "block_k": 64, "heads_per_step": 2},
    {"block_q": 64, "block_k": 64, "heads_per_step": 16},
    {"block_q": 512, "block_k": 512, "heads_per_step": 2},
    {"block_q": None, "block_k": None, "heads_per_step": 1},
    # out of range: the H100 trap (None blocks count as 1024), hp 32,
    # a block below 8, a float
    {"block_q": None, "block_k": None, "heads_per_step": 2},
    {"block_q": 64, "block_k": 64, "heads_per_step": 32},
    {"block_q": 4, "block_k": 64, "heads_per_step": 1},
    {"block_q": 64.0, "block_k": 64, "heads_per_step": 2},
]


@pytest.mark.parametrize("cfg", _CFGS)
def test_tuned_flash_config_is_the_jax_lookup(tmp_cache, cfg):
    """Both packages' `_tuned_flash_config` on one cache file: the same
    config or None, the same warning, and None off self-attention."""
    tune.record("flash_sdpa", tune.flash_attrs(
        2, 4, 128, 128, 64, torch.bfloat16, True), cfg)
    jtune.invalidate()
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tfa._tuned_flash_config(2, 4, 128, 128, 64, torch.bfloat16,
                                      True, "none", False)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jfa._tuned_flash_config(2, 4, 128, 128, 64, jnp.bfloat16,
                                       True, "none", False)
    assert got == want
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert tfa._tuned_flash_config(2, 4, 128, 256, 64, torch.bfloat16,
                                   True, "none", False) is None


@pytest.mark.parametrize("hp,h,want_dbias", [
    (None, 16, False), (1, 16, False), (2, 16, False), (16, 16, False),
    (3, 16, False), (32, 16, False), (0, 4, False), (-2, 4, False),
    (2, 16, True)])
def test_resolve_heads_per_step_is_the_jax_rule(tmp_cache, hp, h,
                                                want_dbias):
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tfa._resolve_heads_per_step(hp, h, want_dbias)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jfa._resolve_heads_per_step(hp, h, want_dbias)
    assert got == want
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]


@pytest.mark.parametrize("blk,seq", [(None, 64), (64, 128), (48, 64),
                                     (512, 384), (64, 77)])
def test_fit_block_is_the_jax_rule(tmp_cache, blk, seq):
    outcome = []
    for fn in (tfa._fit_block, jfa._fit_block):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            try:
                outcome.append((fn(blk, seq, "block_q"),
                                [str(x.message) for x in w]))
            except ValueError as e:
                outcome.append(("raised", str(e)))
    assert outcome[0] == outcome[1]


def _jax_route(sk, d, hp):
    """The kernel JAX's `_bwd_impl` launches for (sk, d, hp), read off the
    `pallas_call` it builds while tracing (nothing runs)."""
    names = []
    orig = jfa.pl

    class _Pl:
        def __getattr__(self, name):
            return getattr(orig, name)

        @staticmethod
        def pallas_call(kernel, *, out_shape, **kw):
            names.append(kernel.func.__name__)
            if not isinstance(out_shape, (list, tuple)):
                return lambda *args: jnp.zeros(out_shape.shape,
                                               out_shape.dtype)
            return lambda *args: [jnp.zeros(o.shape, o.dtype)
                                  for o in out_shape]

    h = 16
    x = jax.ShapeDtypeStruct((1, h, sk, d), jnp.bfloat16)
    lse = jax.ShapeDtypeStruct((1, h, sk), jnp.float32)
    jfa.pl = _Pl()
    try:
        jax.eval_shape(lambda q, k, v, o, l, do: jfa._bwd_impl(
            q, k, v, o, l, do, 0.125, True, block_q=64, block_k=64,
            heads_per_step=hp), x, x, x, x, lse, x)
    finally:
        jfa.pl = orig
    return {"_bwd_fused_kernel_packed": "packed",
            "_bwd_fused_kernel": "fused"}.get(names[0], "split")


@pytest.mark.parametrize("sk,d,hp", [
    (1024, 64, 1), (1024, 64, 2), (1024, 64, 8), (1024, 64, 16),
    (512, 64, 16), (2048, 64, 4), (2048, 64, 8), (2048, 128, 2),
    (4096, 64, 2), (4160, 64, 2), (8192, 64, 2), (2048, 64, 16)])
def test_backward_route_with_packing_is_the_jax_rule(sk, d, hp):
    assert tfa._FUSED_BWD_CAP_PACKED == jfa._FUSED_BWD_CAP_PACKED
    assert tfa.backward_route(sk, d, hp) == _jax_route(sk, d, hp)


def _flash_call_recorder(monkeypatch):
    """Make `flash_attention` take its CUDA branch on CPU tensors and
    record the hp it hands `_FlashFn` instead of launching anything."""
    calls = []

    def apply(q, k, v, scale, causal, q_seg, kv_seg, hp):
        calls.append(hp)
        return q

    monkeypatch.setattr(tfa, "check_kernel_device", lambda *ts: True)
    monkeypatch.setattr(tfa._FlashFn, "apply", apply)
    return calls


def test_flash_attention_consults_the_tuner_on_the_kernel_path(
        tmp_cache, monkeypatch):
    x = torch.zeros(2, 4, 128, 64, dtype=torch.bfloat16)
    attrs = tune.flash_attrs(2, 4, 128, 128, 64, torch.bfloat16, True)
    # on the CPU's plain path no lookup is made
    tfa.flash_attention(x, x, x, causal=True)
    assert tune.stats()["misses"] == 0
    calls = _flash_call_recorder(monkeypatch)
    tfa.flash_attention(x, x, x, causal=True)              # a miss
    tune.record("flash_sdpa", attrs,
                {"block_q": 64, "block_k": 64, "heads_per_step": 2})
    tfa.flash_attention(x, x, x, causal=True)              # a hit
    tfa.flash_attention(x, x, x, causal=True, heads_per_step=1)
    tfa.flash_attention(x, x, x, causal=False)             # another key
    assert calls == [1, 2, 1, 1]
    s = tune.stats()
    assert (s["hits"], s["misses"]) == (1, 2)
    monkeypatch.setenv(tune.ENV_DISABLE, "0")
    tfa.flash_attention(x, x, x, causal=True)
    assert calls[-1] == 1
    monkeypatch.delenv(tune.ENV_DISABLE)
    # a tuned hp that does not divide h, explicit bad knobs: warn, unpacked
    tune.record("flash_sdpa", attrs,
                {"block_q": 64, "block_k": 64, "heads_per_step": 8})
    with pytest.warns(UserWarning, match="heads_per_step=8"):
        tfa.flash_attention(x, x, x, causal=True)
    with pytest.warns(UserWarning, match="block_q=48"):
        tfa.flash_attention(x, x, x, causal=True, block_q=48,
                            heads_per_step=4)
    assert calls[-2:] == [1, 4]


def test_flash_attention_with_an_empty_cache_runs_unpacked(
        tmp_cache, monkeypatch):
    calls = _flash_call_recorder(monkeypatch)
    for shape in ((12, 16, 1024, 64), (32, 16, 512, 64), (8, 16, 2048, 64)):
        x = torch.zeros(shape, dtype=torch.bfloat16)
        tfa.flash_attention(x, x, x, causal=True)
    assert calls == [1, 1, 1]
    assert tune.stats()["hits"] == 0


# ----------------------------- serving lookups ------------------------------

@pytest.mark.parametrize("page,want", [(64, 64), (16, 16), (2048, 2048),
                                       (12, 128), (4096, 128), ("64", 128)])
def test_default_page_size_consults_serve_page(tmp_cache, page, want):
    assert tkv.default_page_size(16, 64, torch.bfloat16) == 128
    tune.record("serve_page", tune.serve_page_attrs(16, 64, torch.bfloat16),
                {"page_size": page})
    assert tkv.default_page_size(16, 64, torch.bfloat16) == want
    jtune.invalidate()
    from apex_tpu.serve import kv_cache as jkv
    assert jkv.default_page_size(16, 64, jnp.bfloat16) == want
    assert tkv.KVCacheConfig(1, 16, 64, 4, 8, 2).page_size == want


@pytest.mark.parametrize("hp", [1, 2, 4, 3, 32, "2"])
def test_tuned_decode_config_is_the_jax_lookup(tmp_cache, hp):
    args = (64, 1, 16, 16, 64, 128)
    tune.record("flash_decode", tune.decode_attrs(*args, torch.bfloat16),
                {"heads_per_step": hp})
    jtune.invalidate()
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tfd._tuned_decode_config(*args, torch.bfloat16)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jfd._tuned_decode_config(*args, jnp.bfloat16)
    assert got == want
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]


def test_flash_decode_consults_the_tuner_only_on_the_kernel_path(
        tmp_cache, monkeypatch):
    q = torch.zeros(4, 1, 4, 64)
    pages = torch.zeros(4, 9, 16, 64)
    tbl = torch.ones(4, 2, dtype=torch.int32)
    lens = torch.tensor([0, 3, 16, 20], dtype=torch.int32)
    tune.record("flash_decode", tune.decode_attrs(4, 1, 4, 4, 64, 16,
                                                  torch.float32),
                {"heads_per_step": 3})
    tfd.flash_decode(q, pages, pages, tbl, lens)
    assert tune.stats()["hits"] == 0
    launched = []
    monkeypatch.setattr(tfd, "check_kernel_device", lambda *ts: True)
    monkeypatch.setattr(tfd, "flash_decode_cuda",
                        lambda *a: launched.append(a) or a[0])
    with pytest.warns(UserWarning, match="out-of-range tuned config"):
        tfd.flash_decode(q, pages, pages, tbl, lens)
    assert tune.stats()["hits"] == 1 and len(launched) == 1


# --------------------------------- search -----------------------------------

def test_flash_candidates_are_the_cuda_tile_and_dividing_packings():
    assert search.flash_candidates(16, 2048, 2048) == [
        {"block_q": 64, "block_k": 64, "heads_per_step": hp}
        for hp in (1, 2, 4, 8, 16)]
    assert [c["heads_per_step"]
            for c in search.flash_candidates(12, 64, 64)] == [1, 2, 4]
    assert search.flash_candidates(4, 200, 200)[0]["block_q"] == 8
    with pytest.raises(ValueError, match="no power-of-two block"):
        search.flash_candidates(4, 77, 77)
    # every candidate passes the lookup's validation (the H100 trap)
    for cand in search.flash_candidates(16, 2048, 2048):
        assert cand["heads_per_step"] * cand["block_q"] * cand["block_k"] \
            <= tfa._TUNED_SCORE_ELEMS_CAP


def test_tune_flash_records_a_winner_that_tuned_returns(tmp_cache):
    best, results = search.tune_flash(1, 4, 64, 16, dtype=torch.float32,
                                      iters=1, warmup=1, device="cpu",
                                      meta={"device": "cpu"})
    assert [c["heads_per_step"] for c, _ in sorted(
        results, key=lambda r: r[0]["heads_per_step"])] == [1, 2, 4]
    assert best == results[0][0] and all(t > 0 for _, t in results)
    attrs = tune.flash_attrs(1, 4, 64, 64, 16, torch.float32, True)
    assert tune.tuned("flash_sdpa", attrs) == best
    meta = json.loads(tmp_cache.read_text())["entries"]["cpu"][
        tune.make_key("flash_sdpa", attrs)]["meta"]
    assert meta["device"] == "cpu" and meta["swept"] == 3
    assert set(meta["candidates_ms"]) == {"1", "2", "4"}
    # the config is one `_tuned_flash_config` takes
    assert tfa._tuned_flash_config(1, 4, 64, 64, 16, torch.float32, True,
                                   "none", False) == best


def test_forced_pins_a_config_in_memory_only(tmp_cache):
    with search.forced("flash_sdpa", _ATTRS, {"heads_per_step": 4}):
        assert tune.tuned("flash_sdpa", _ATTRS) == {"heads_per_step": 4}
    assert tune.tuned("flash_sdpa", _ATTRS) is None
    assert not tmp_cache.exists()
