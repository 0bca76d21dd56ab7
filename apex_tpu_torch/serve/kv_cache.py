"""Paged KV cache (counterpart of apex_tpu/serve/kv_cache.py) — a fixed
pool of device pages shared by every live sequence.

Fixed-shape contract, as in the JAX package:

  * the pool tensors ``k_pages``/``v_pages`` are allocated ONCE at
    engine construction — ``(n_layers, n_kv_heads, n_pages,
    page_size, head_dim)`` — and never reshaped;
  * the block table is ``(n_slots, pages_per_slot_max)`` int32 and
    never reshaped; admission/retirement edit VALUES only;
  * page 0 is the TRASH page: it is never allocated to a sequence, and
    every masked-out write (inactive slots, prompt padding) is routed
    to it, so the scatter that writes new K/V needs no dynamic shape or
    host branch;
  * stale table entries and partial last pages are masked BY POSITION
    in the decode kernel (ops/flash_decode.py), never by data — a
    recycled page needs no cleaning between requests.

Allocation is HOST-side (a free list of page ids) and happens only at
admission/retirement.  Pages for a request are reserved at admission
for its worst case (prompt + max_new_tokens), so a decode step never
asks the host for memory.

``page_size`` defaults to the JAX package's heuristic, 128; the tuner
lookup that can override it waits for the port of `apex_tpu.tune`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from apex_tpu_torch.ops._common import resolve_device

# the reserved trash page (module contract above)
TRASH_PAGE = 0


class PageAccountingError(ValueError):
    """The free-list accounting was about to be corrupted: a release of
    a slot that holds no pages (double release, or a slot that was
    never allocated).  Raised BY NAME instead of silently extending the
    free list — a silent one would hand the same page to two sequences
    later."""


def default_page_size(n_kv_heads: int, head_dim: int, dtype=None) -> int:
    """The page size when none is configured: 128, the JAX package's
    heuristic (its tuner lookup is not ported yet).  On Hopper a
    128-token page at d=64 in bf16 is 16 KiB per kv head."""
    del n_kv_heads, head_dim, dtype
    return 128


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Static layout of the paged pool.

    page_size None takes `default_page_size`.  n_pages includes the
    trash page; ``usable_pages`` is what requests can actually own.
    pages_per_slot_max bounds one sequence's table row (its max length
    is pages_per_slot_max * page_size)."""

    n_layers: int
    n_kv_heads: int
    head_dim: int
    n_slots: int
    n_pages: int
    pages_per_slot_max: int
    page_size: Optional[int] = None
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.page_size is None:
            object.__setattr__(
                self, "page_size",
                default_page_size(self.n_kv_heads, self.head_dim,
                                  self.dtype))
        if self.n_pages < 2:
            raise ValueError(
                f"n_pages={self.n_pages}: need at least the trash page "
                "+ one usable page")
        if self.n_slots < 1 or self.pages_per_slot_max < 1:
            raise ValueError("n_slots and pages_per_slot_max must be >= 1")

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1          # page 0 is the trash page

    @property
    def max_seq_len(self) -> int:
        """Longest sequence one table row can address."""
        return self.pages_per_slot_max * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        """Pages a sequence of n_tokens tokens occupies."""
        return -(-max(0, int(n_tokens)) // self.page_size)

    # ------------------------------ pricing ------------------------------

    def page_bytes(self) -> int:
        """Device bytes of ONE page across all layers, K and V."""
        return (2 * self.n_layers * self.n_kv_heads * self.page_size
                * self.head_dim * _itemsize(self.dtype))

    def pool_bytes(self) -> int:
        """Total device bytes of the page pool."""
        return self.n_pages * self.page_bytes()

    def bytes_per_token(self) -> int:
        """Cache bytes one token costs (all layers, K+V)."""
        return (2 * self.n_layers * self.n_kv_heads * self.head_dim
                * _itemsize(self.dtype))

    def bytes_per_user(self, seq_len: int) -> int:
        """Cache bytes one concurrent user at seq_len costs — page
        granularity included (the partial last page is paid in full)."""
        return self.pages_for(seq_len) * self.page_bytes()


class PagedKVCache:
    """The pool + the host-side free-list allocator.

    Device side: ``k_pages``/``v_pages`` tensors in the kernel's layout
    and a ``block_table`` int32 tensor (all fixed shapes), on `device`
    (the card unless the caller passes another).  The ENGINE
    owns the device tensors once decoding starts; this object keeps the
    authoritative host mirror of the table and the free list, and hands
    out fresh device tables after admission edits.

    Host side: ``allocate_slot`` pops page ids from the free list (None
    when the pool can't serve the request — the scheduler's
    admission-control signal), ``release_slot`` returns them.  Page 0
    (TRASH_PAGE) is never handed out.
    """

    def __init__(self, config: KVCacheConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        c = config
        self._free: List[int] = list(range(1, c.n_pages))
        # host mirror of the block table; unassigned entries point at
        # the trash page (read-harmless: masked by position)
        self._table = np.full((c.n_slots, c.pages_per_slot_max),
                              TRASH_PAGE, np.int32)
        self._slot_pages: Dict[int, List[int]] = {}

    # ------------------------- device tensors ------------------------

    def init_pages(self):
        """Fresh zeroed (k_pages, v_pages) pool tensors in the decode
        kernel's layout, on the cache's device.  Zeros are a
        convenience, not a correctness requirement — the position
        masking contract means garbage would serve equally."""
        c = self.config
        shape = (c.n_layers, c.n_kv_heads, c.n_pages, c.page_size,
                 c.head_dim)
        return (torch.zeros(shape, dtype=c.dtype, device=self.device),
                torch.zeros(shape, dtype=c.dtype, device=self.device))

    def device_table(self) -> torch.Tensor:
        """The current block table as a device tensor (push after
        admission edits; the shape never changes)."""
        return torch.tensor(self._table, device=self.device)  # a copy

    # ------------------------- allocation ----------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_admit(self, n_tokens: int) -> bool:
        n = self.config.pages_for(n_tokens)
        return n <= len(self._free) and n <= self.config.pages_per_slot_max

    def allocate_slot(self, slot: int, n_tokens: int) -> Optional[np.ndarray]:
        """Reserve pages for a sequence of up to n_tokens tokens in
        `slot` and point the slot's table row at them.  Returns the
        row (int32, pages_per_slot_max) or None when the pool or the
        table row cannot serve it — the caller queues the request."""
        c = self.config
        if slot in self._slot_pages:
            raise ValueError(f"slot {slot} already holds pages; "
                             "release_slot first")
        n = c.pages_for(n_tokens)
        if n > c.pages_per_slot_max or n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._slot_pages[slot] = pages
        row = np.full((c.pages_per_slot_max,), TRASH_PAGE, np.int32)
        row[:n] = pages
        self._table[slot] = row
        return row

    def release_slot(self, slot: int) -> None:
        """Return a retired slot's pages to the pool.  The table row
        keeps its (now stale) entries until reassignment — stale ids
        are read-harmless by the position-masking contract.  A release
        of a slot holding no pages raises `PageAccountingError`."""
        if slot not in self._slot_pages:
            raise PageAccountingError(
                f"release_slot({slot}): slot holds no pages — double "
                "release, or a slot that was never allocated")
        self._free.extend(self._slot_pages.pop(slot))

    def slot_pages(self, slot: int) -> List[int]:
        return list(self._slot_pages.get(slot, ()))

    # ------------------------- checkpoint ----------------------------

    def state_dict(self) -> dict:
        """Host snapshot of the allocator: free list, table mirror,
        slot→pages assignments."""
        return {"free": list(self._free),
                "table": self._table.copy(),
                "slot_pages": {int(s): list(p)
                               for s, p in self._slot_pages.items()}}

    def load_state_dict(self, d: dict) -> None:
        """Inverse of state_dict under THIS config.  Validates the page
        accounting (every page trash-or-accounted exactly once) so a
        snapshot from a different deployment fails loudly instead of
        double-allocating pages later."""
        c = self.config
        free = [int(p) for p in d["free"]]
        slot_pages = {int(s): [int(p) for p in pp]
                      for s, pp in d["slot_pages"].items()}
        held = [p for pp in slot_pages.values() for p in pp]
        accounted = sorted(free + held)
        if accounted != list(range(1, c.n_pages)):
            raise ValueError(
                f"PagedKVCache.load_state_dict: snapshot accounts for "
                f"{len(accounted)} pages, this deployment has "
                f"{c.n_pages - 1} usable ones (n_pages={c.n_pages}) — "
                "snapshot is from a different deployment or corrupt")
        table = np.asarray(d["table"], np.int32)
        if table.shape != self._table.shape:
            raise ValueError(
                f"PagedKVCache.load_state_dict: table shape "
                f"{table.shape} != configured {self._table.shape}")
        self._free = free
        self._table = table.copy()
        self._slot_pages = slot_pages


def gather_slot(k_pages, v_pages, table_row, length: int, layer: int = 0):
    """Test helper: the contiguous (length, n_kv_heads, head_dim) K and V
    of one slot, gathered through its table row — the dense view the
    parity tests compare the kernel against."""
    c_page = k_pages.shape[3]
    n = -(-length // c_page)
    ids = torch.as_tensor(table_row[:n], device=k_pages.device).long()
    k = k_pages[layer][:, ids]   # (hkv, n, page, d)
    v = v_pages[layer][:, ids]
    k = k.reshape(k.shape[0], -1, k.shape[-1])[:, :length]
    v = v.reshape(v.shape[0], -1, v.shape[-1])[:, :length]
    return k.permute(1, 0, 2), v.permute(1, 0, 2)
