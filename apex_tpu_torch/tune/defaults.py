"""Committed tuned-config defaults, keyed by device kind (counterpart of
apex_tpu/tune/defaults.py).  Structure: one device-kind section of the
cache file each, {kind: {key: {"config": ..., "meta": ...}}}; a user
cache layers its entries over these (cache._merged_for_kind).

"v5e" is the JAX package's section, copied as data so the two packages
give one cache file the same merged view and fingerprint; the port
never runs on a TPU, so no lookup of the port reads it.

"h100" holds only winners that `search.tune_flash` measured on an H100
(`chip_smoke.py`'s slice-8 phase prints every candidate's time), with
their ms, the card's name and its power limit in `meta`.  Entries go
only at the ATTENTION bench shapes, never at a model step's shapes
(GPT-350M b12 s1024, BERT b32 s512): a headline step must not run an
unmeasured config, and a step's attention is timed inside the step, not
alone.  The section is empty: on the card no packed candidate beat
heads_per_step=1 at the MHA bench shape by more than the run-to-run
spread (PERF.md § 6), so every shape keeps the unpacked kernels.
"""

from __future__ import annotations

_V5E_NOTE = ("committed v5e default (attention bench shapes); refresh "
             "with scripts/gpt_anatomy.py tune")
_V5E_PACK2 = {"block_q": 512, "block_k": 512, "heads_per_step": 2}


def _v5e(config, note=_V5E_NOTE):
    return {"config": dict(config), "meta": {"note": note}}


DEFAULTS = {
    "v5e": {
        # GPT-1.3B seq-2048, the MHA bench point, the 32k leg
        "flash_sdpa|b=4,bias=none,causal=1,d=64,dtype=bfloat16,h=32,seg=0,"
        "sk=2048,sq=2048": _v5e(_V5E_PACK2),
        "flash_sdpa|b=8,bias=none,causal=1,d=64,dtype=bfloat16,h=16,seg=0,"
        "sk=2048,sq=2048": _v5e(_V5E_PACK2),
        "flash_sdpa|b=1,bias=none,causal=1,d=64,dtype=bfloat16,h=8,seg=0,"
        "sk=32768,sq=32768": _v5e(_V5E_PACK2),
        "opt_flat|kernel=adam,rows=8388608": _v5e(
            {"block_rows": 512},
            "v5e 1B-param sweep: 512 rows = 721 GB/s (docs/PERF.md)"),
    },
    "h100": {},
}
