"""Continuous-batching decode engine (counterpart of apex_tpu/serve/engine.py).

Requests arrive and finish at their own pace; the engine holds the
decode step's shapes FIXED and moves only VALUES underneath it:

  * decoding runs over a fixed grid of ``n_slots`` request slots; a
    slot is active when its ``lengths`` entry is nonzero and its
    ``done`` flag is clear — admission and retirement flip values in
    these tensors, never shapes, so every GEMM keeps its M;
  * the paged KV pool and the block table are fixed-shape
    (serve/kv_cache.py); admission points a slot's table row at
    freshly reserved pages, retirement returns them;
  * per-slot decode state (position, current token, generated count,
    done flag, output ring) lives ON THE DEVICE, so a decode step reads
    and writes it without a host sync;
  * inactive slots ride through the step as exact no-ops: the decode
    kernel returns zeros for length-0 slots and their K/V writes are
    routed to the trash page.

The fixed-shape contract is ENFORCED: the decode step is wrapped in a
`RecompileSentry` (monitor.compile) marked steady after warmup; a later
change of the step's argument signature counts as a steady-state
recompile and turns `recompile_ok` False.

The ONLY host/device traffic in steady state is the scheduler's retire
poll (the (n_slots,) done flags, plus counts and output rows when a slot
finishes) — `state.done.cpu()` is the engine's one sync point per step.

Failure semantics, as in the JAX package: per-request deadlines,
cancellation through the `done` mask, a bounded admission queue with
shed policies and SLO-driven proactive shedding, `drain()` returning a
restorable snapshot, and the retire poll's validity guard
(`PoisonedOutputError`).  `serve.watchdog.EngineWatchdog` notices a
stalled engine by its heartbeat, `steps_completed`, and restarts it from
a snapshot.

Model and numerics: the forward mirrors the JAX engine op for op (same
LayerNorm, same packed-QKV split order, GEMMs accumulating in fp32 then
rounded to the compute dtype, fp32 logits, greedy argmax taking the
first maximal index).  `strict_matmul_numerics()` is applied where the
engine is built: bf16 GEMMs reduce in fp32 and fp32 matmuls run without
TF32, since prefill attention is an fp32 einsum.  Prefill runs the
prompt densely at the fixed padded length `max_prompt_len`; decode runs
the paged flash-decode kernel (ops/flash_decode.py) and every LayerNorm
runs the Triton kernel (ops/layer_norm.py).

Unlike the JAX engine, which donates its buffers to a pure function,
this one updates the KV pool IN PLACE (an index_put on one layer's view
of the pool), and prefill writes its slot's row of the decode state in
place.  Inactive slots and prompt padding all write the trash page:
which of several duplicate writes wins is unspecified, which is
harmless only because the trash page is masked by position.  Every
entry point runs under `torch.inference_mode()`.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch.checkpoint import chaos as _chaos
from apex_tpu_torch.monitor.compile import RecompileSentry
from apex_tpu_torch.ops._common import resolve_device, strict_matmul_numerics
from apex_tpu_torch.ops.flash_decode import flash_decode
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.serve.kv_cache import (TRASH_PAGE, KVCacheConfig,
                                           PagedKVCache, default_page_size)
from apex_tpu_torch.serve.telemetry import (ServeTelemetry,
                                            step_latency_percentiles)

_NEG_INF = -1e30

# decode-step warmup allowance before the sentry is force-marked
# steady: a step whose signature changed EVERY call would otherwise
# never leave warmup and the recompile gate would fail open
_STEADY_WARMUP_CAP = 6

# admission/shed policies for the bounded queue
SHED_POLICIES = ("shed-newest", "shed-lowest-deadline")


class PoisonedOutputError(RuntimeError):
    """The retire poll fetched token ids outside [0, vocab) for a
    finishing slot — the decode plane emitted garbage (the
    `serve.poison_logits` chaos point injects it).  Recovery is a
    restart from the last good snapshot."""

    def __init__(self, msg: str, slot: Optional[int] = None,
                 request_id: Optional[int] = None,
                 step: Optional[int] = None):
        super().__init__(msg)
        self.slot = slot
        self.request_id = request_id
        self.step = step


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static serving-side knobs.  The shape-bearing fields fix the
    decode step's shapes — change one and you have a NEW deployment.
    The overload-control fields (`max_queue_depth`, `shed_policy`) are
    host scheduler policy only and are absent from the deployment
    fingerprint (a snapshot restores across a policy change).

    n_pages None sizes the pool so `pool_fraction` of the worst case
    (every slot at max_prompt_len + max_new_cap) fits.  eos_id None
    disables EOS termination.  max_queue_depth None keeps the queue
    unbounded; a bound arms the shed path."""

    n_slots: int = 64
    max_prompt_len: int = 128
    max_new_cap: int = 128
    eos_id: Optional[int] = None
    page_size: Optional[int] = None
    n_pages: Optional[int] = None
    pool_fraction: float = 0.5
    cache_dtype: Any = None          # None → the model compute dtype
    emit_logits: bool = False        # decode also returns (slots, V) logits
    max_queue_depth: Optional[int] = None
    shed_policy: str = "shed-newest"


@dataclasses.dataclass
class FinishedRequest:
    """One ended request, as `poll()` hands it back.  `status` is the
    terminal state (serve/telemetry.py): "ok" carries the full
    generation; "expired"/"cancelled" carry the partial tokens; "shed"
    carries none."""

    request_id: int
    prompt: List[int]
    tokens: List[int]                # generated ids (greedy), EOS included
    n_prompt: int = 0
    status: str = "ok"

    def __post_init__(self):
        self.n_prompt = len(self.prompt)


@dataclasses.dataclass
class _Request:
    """Host scheduler bookkeeping for one queued or live request.
    `deadline_t`/`submit_t` are perf_counter-absolute; the snapshot
    serializes them as AGES so they survive a cross-process restore."""

    rid: int
    prompt: List[int]
    max_new: int
    submit_t: float
    deadline_t: Optional[float] = None
    deadline_ms: Optional[float] = None

    def expired(self, now: float) -> bool:
        return self.deadline_t is not None and now >= self.deadline_t


class DecodeState(NamedTuple):
    """Per-slot device state — every leaf is (n_slots, ...) and fixed
    shape."""

    block_table: torch.Tensor    # (n_slots, pages_per_slot_max) i32
    lengths: torch.Tensor        # (n_slots,) i32 — tokens IN the cache
    cur_tokens: torch.Tensor     # (n_slots,) i32 — next token to decode
    n_generated: torch.Tensor    # (n_slots,) i32
    max_new: torch.Tensor        # (n_slots,) i32 — per-request budget
    done: torch.Tensor           # (n_slots,) bool
    out_tokens: torch.Tensor     # (n_slots, max_new_cap) i32


def choose_shed_victim(candidates, policy: str):
    """The one shed-policy spelling.  `candidates` are queued requests
    in FIFO order with the INCOMING request last; each carries `.rid`
    and `.deadline_t` (None = no deadline).  Returns the victim:

    * `shed-newest` — the incoming request;
    * `shed-lowest-deadline` — the EARLIEST-deadline candidate (the
      least slack); deadline-less requests are shed last; ties break
      toward the newest (highest rid)."""
    if policy == "shed-newest":
        return candidates[-1]
    if policy != "shed-lowest-deadline":
        raise ValueError(f"unknown shed policy {policy!r}; choices: "
                         f"{SHED_POLICIES}")
    return min(candidates,
               key=lambda r: (r.deadline_t if r.deadline_t is not None
                              else math.inf, -r.rid))


def _dot(x, w, b=None):
    """The TP layers' GEMM spelling: x @ w accumulated in fp32 and
    rounded to x's dtype (`strict_matmul_numerics`), then the bias
    added in that dtype."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _mm_out_dtype_on_cuda() -> bool:
    """Whether this torch has `aten::mm.dtype` (bf16 operands, fp32
    output, no bf16 round) for CUDA."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::mm.dtype", "CUDA")


class DecodeEngine:
    """Continuous-batching server over a GPT parameter dict.

    >>> eng = DecodeEngine(model_cfg, params, ServeConfig(n_slots=64))
    >>> rid = eng.submit([1, 2, 3], max_new_tokens=16)
    >>> while eng.pending:
    ...     eng.step()
    ...     for fin in eng.poll(): ...

    `step()` = retire finished slots → admit queued requests (prefill)
    → one decode step for ALL slots.  `recompile_ok` is False the
    moment the decode step's argument signature changes in steady
    state.  `device` defaults to the card; pass "cpu" to run the plain
    PyTorch versions of the kernels.
    """

    @torch.inference_mode()
    def __init__(self, model_cfg, params, serve_cfg: ServeConfig,
                 recorder=None, telemetry=True, slo=None, device=None):
        c, s = model_cfg, serve_cfg
        if c.hidden % c.num_heads:
            raise ValueError(
                f"num_heads={c.num_heads} must divide hidden={c.hidden} "
                "(head_dim = hidden // num_heads)")
        if s.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy {s.shed_policy!r} not in {SHED_POLICIES}")
        if s.max_queue_depth is not None and s.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1 (or None for unbounded), "
                f"got {s.max_queue_depth}")
        self.device = resolve_device(device)
        if params["embed"]["weight"].device != self.device:
            raise ValueError(
                f"params live on {params['embed']['weight'].device}, the "
                f"engine on {self.device}")
        strict_matmul_numerics()
        self.model_cfg = c
        self.serve_cfg = s
        self.params = params
        max_len = s.max_prompt_len + s.max_new_cap
        if max_len > c.seq_len:
            raise ValueError(
                f"max_prompt_len + max_new_cap = {max_len} exceeds the "
                f"model's seq_len {c.seq_len} (no positions for it)")
        cache_dtype = s.cache_dtype if s.cache_dtype is not None else c.dtype
        page = (s.page_size if s.page_size is not None else
                default_page_size(c.num_heads, c.head_dim, cache_dtype))
        per_slot = -(-max_len // page)
        n_pages = s.n_pages
        if n_pages is None:
            worst = s.n_slots * per_slot
            n_pages = 1 + max(per_slot, int(math.ceil(
                worst * s.pool_fraction)))
        self.kv_config = KVCacheConfig(
            n_layers=c.num_layers, n_kv_heads=c.num_heads,
            head_dim=c.head_dim, n_slots=s.n_slots, n_pages=n_pages,
            pages_per_slot_max=per_slot, page_size=page,
            dtype=cache_dtype)
        self.cache = PagedKVCache(self.kv_config, device=self.device)
        k_pages, v_pages = self.cache.init_pages()
        self.kv = {"k_pages": k_pages, "v_pages": v_pages}
        ns = s.n_slots

        def zi(*sh):
            return torch.zeros(sh, dtype=torch.int32, device=self.device)

        self.state = DecodeState(
            block_table=self.cache.device_table(),
            lengths=zi(ns), cur_tokens=zi(ns), n_generated=zi(ns),
            max_new=zi(ns),
            done=torch.zeros((ns,), dtype=torch.bool, device=self.device),
            out_tokens=zi(ns, s.max_new_cap))
        self._logits_out_dtype = (self.device.type == "cuda"
                                  and _mm_out_dtype_on_cuda())

        self.decode_step = self._decode_fn
        # kept so a watchdog restart rebuilds the engine with the same
        # flight recorder
        self.recorder = recorder
        self.sentry = RecompileSentry(self.decode_step,
                                      name="serve_decode",
                                      recorder=recorder, warn=True)
        self._steady = False
        self.last_logits = None

        self._next_rid = 0
        self._pending = collections.deque()    # _Request, FIFO
        self._free_slots = list(range(ns - 1, -1, -1))
        self._live: Dict[int, _Request] = {}   # slot -> _Request
        self._finished: List[FinishedRequest] = []
        self._draining = False
        self._stalled = False
        self._evict_status: Dict[int, str] = {}   # slot -> "cancelled"
        self.steps_completed = 0     # retire-poll progress counter (a
        #                              watchdog's heartbeat: a stalled
        #                              step never bumps it)
        self.prefills = 0            # admissions that ran a prefill
        self.last_shed_rid: Optional[int] = None  # per-submit signal
        self.watchdog = None         # set by EngineWatchdog.__init__

        # serving observatory: pure host bookkeeping.  telemetry=
        # accepts True (default ServeTelemetry), a ServeTelemetry
        # instance, or False/None (off).  slo= is an optional ServeSLO
        # whose verdict `serve_record()` stamps as `serve_slo_ok`.
        if telemetry is True:
            telemetry = ServeTelemetry()
        self.telemetry = telemetry or None
        self.slo = slo
        # requests admitted since the last retire poll: their first
        # token is bounded by the NEXT poll's device fetch
        self._awaiting_first: List[int] = []
        if (recorder is not None and self.telemetry is not None
                and hasattr(recorder, "attach_serve")):
            recorder.attach_serve(self)

    # ------------------------------------------------------------------
    # model forward pieces (mirror the JAX engine op for op)
    # ------------------------------------------------------------------

    def _split_qkv(self, qkv):
        """(rows, 3H) → three (rows, nh, d) views, in the packing order
        ((..., 3, nh, d) major-to-minor) of the JAX package's
        qkv_split_heads, so its checkpoints serve unchanged."""
        c = self.model_cfg
        qkv = qkv.reshape(qkv.shape[0], 3, c.num_heads, c.head_dim)
        return qkv[:, 0], qkv[:, 1], qkv[:, 2]

    def _mlp(self, bp, x):
        h = fused_layer_norm(x, bp["ln2"]["weight"], bp["ln2"]["bias"])
        m = _dot(h, bp["fc1"]["weight"], bp["fc1"]["bias"])
        m = F.gelu(m, approximate="tanh")
        return _dot(m, bp["fc2"]["weight"], bp["fc2"]["bias"])

    def _logits(self, params, h):
        """Tied-embedding LM head, fp32 logits from compute-dtype
        operands without rounding the products to the compute dtype:
        `mm` with an fp32 output where this torch has it for CUDA, an
        fp32 upcast of both operands (exact products, fp32 sums)
        elsewhere."""
        w = params["embed"]["weight"]
        if self._logits_out_dtype and h.dtype != torch.float32:
            return torch.mm(h, w.t(), out_dtype=torch.float32)
        return torch.mm(h.float(), w.float().t())

    def _write_layer(self, kv, layer, pos_flat, k_new, v_new):
        """Scatter one layer's new K/V rows into the paged pool IN PLACE.
        pos_flat: (rows,) int64 flattened page*page_size + offset
        positions (trash-page routed where masked); k_new/v_new:
        (rows, hkv, d)."""
        cfg = self.kv_config
        hkv, npg, page, d = (cfg.n_kv_heads, cfg.n_pages, cfg.page_size,
                             cfg.head_dim)
        for name, new in (("k_pages", k_new), ("v_pages", v_new)):
            flat = kv[name][layer].view(hkv, npg * page, d)
            flat[:, pos_flat] = new.transpose(0, 1).to(flat.dtype)

    # ------------------------------------------------------------------
    # decode step (fixed shapes forever)
    # ------------------------------------------------------------------

    def _decode_fn(self, params, kv, state):
        c, s = self.model_cfg, self.serve_cfg
        cfg = self.kv_config
        page = cfg.page_size
        ns = s.n_slots
        scale = 1.0 / math.sqrt(c.head_dim)
        active = (~state.done) & (state.lengths > 0)

        pos = state.lengths.clamp(0, c.seq_len - 1).long()
        x = (params["embed"]["weight"][state.cur_tokens.long()]
             + params["pos_embed"][pos]).to(c.dtype)

        # the current token's cache position; inactive slots write the
        # trash page (read-harmless, module contract in kv_cache.py).
        # The table index is clamped as JAX's gather clamps it: a
        # finished slot's length may point one past its last page.
        tidx = (state.lengths // page).clamp(
            max=cfg.pages_per_slot_max - 1).long()
        page_ids = state.block_table.gather(1, tidx[:, None])[:, 0]
        page_ids = torch.where(active, page_ids, TRASH_PAGE)
        pos_flat = (page_ids * page + state.lengths % page).long()
        # lengths INCLUDING the token being decoded (flash_decode
        # contract); 0 parks inactive slots on the zero-output path
        vis = torch.where(active, state.lengths + 1, 0)

        for i in range(c.num_layers):
            bp = params[f"block{i}"]
            h = fused_layer_norm(x, bp["ln1"]["weight"],
                                 bp["ln1"]["bias"])
            qkv = _dot(h, bp["qkv"]["weight"], bp["qkv"]["bias"])
            q, k_new, v_new = self._split_qkv(qkv)   # (ns, nh, d)
            self._write_layer(kv, i, pos_flat, k_new, v_new)
            ctx = flash_decode(
                q[:, None], kv["k_pages"][i], kv["v_pages"][i],
                state.block_table, vis, softmax_scale=scale)
            ctx = ctx.reshape(ns, c.hidden).to(c.dtype)
            x = x + _dot(ctx, bp["proj"]["weight"], bp["proj"]["bias"])
            x = x + self._mlp(bp, x)

        h = fused_layer_norm(x, params["final_ln"]["weight"],
                             params["final_ln"]["bias"])
        logits = self._logits(params, h)             # (ns, V) f32
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)

        n_gen = state.n_generated
        idx = n_gen.clamp(0, s.max_new_cap - 1).long()
        arange = torch.arange(ns, device=self.device)
        prev = state.out_tokens[arange, idx]
        out_tokens = state.out_tokens.clone()
        out_tokens[arange, idx] = torch.where(active, nxt, prev)
        if s.eos_id is not None:
            hit_eos = nxt == s.eos_id
        else:
            hit_eos = torch.zeros_like(active)
        newly_done = active & (hit_eos | (n_gen + 1 >= state.max_new))
        act = active.to(torch.int32)
        new_state = DecodeState(
            block_table=state.block_table,
            lengths=state.lengths + act,
            cur_tokens=torch.where(active, nxt, state.cur_tokens),
            n_generated=n_gen + act,
            max_new=state.max_new,
            done=state.done | newly_done,
            out_tokens=out_tokens)
        if s.emit_logits:
            return kv, new_state, logits
        return kv, new_state

    # ------------------------------------------------------------------
    # prefill (padded to max_prompt_len)
    # ------------------------------------------------------------------

    def _prefill_fn(self, params, kv, state, slot: int, tokens,
                    length: int, req_max_new: int):
        """Run one prompt (tokens: (max_prompt_len,) padded ids on the
        device) through the model densely, write its K/V into the slot's
        pages and its row of the decode state in place, and set its
        first token."""
        c, s = self.model_cfg, self.serve_cfg
        cfg = self.kv_config
        page = cfg.page_size
        P = s.max_prompt_len
        scale = 1.0 / math.sqrt(c.head_dim)

        kpos = torch.arange(P, dtype=torch.int32, device=self.device)
        x = (params["embed"]["weight"][tokens.long()]
             + params["pos_embed"][:P]).to(c.dtype)

        valid = kpos < length
        table_row = state.block_table[slot]          # (pages_per_slot,)
        page_ids = table_row[(kpos // page).long()]
        page_ids = torch.where(valid, page_ids, TRASH_PAGE)
        pos_flat = (page_ids * page + kpos % page).long()
        # padding beyond `length` (and the causal future) is masked by
        # POSITION; its garbage K/V rows land on the trash page
        mask = ((kpos[None, None, :] > kpos[None, :, None])
                | (kpos[None, None, :] >= length))

        for i in range(c.num_layers):
            bp = params[f"block{i}"]
            h = fused_layer_norm(x, bp["ln1"]["weight"],
                                 bp["ln1"]["bias"])
            qkv = _dot(h, bp["qkv"]["weight"], bp["qkv"]["bias"])
            q, k_new, v_new = self._split_qkv(qkv)   # (P, nh, d)
            self._write_layer(kv, i, pos_flat, k_new, v_new)
            st = torch.einsum("qnd,knd->nqk", q.float(),
                              k_new.float()) * scale
            st = torch.where(mask, _NEG_INF, st)
            p = torch.softmax(st, dim=-1)
            ctx = torch.einsum("nqk,knd->qnd", p,
                               v_new.float()).to(c.dtype)
            ctx = ctx.reshape(P, c.hidden)
            x = x + _dot(ctx, bp["proj"]["weight"], bp["proj"]["bias"])
            x = x + self._mlp(bp, x)

        h = fused_layer_norm(x, params["final_ln"]["weight"],
                             params["final_ln"]["bias"])
        h_last = h[min(max(length - 1, 0), P - 1)]
        logits = self._logits(params, h_last[None])[0]      # (V,) f32
        first = torch.argmax(logits).to(torch.int32)

        done0 = torch.full((), req_max_new <= 1, device=self.device)
        if s.eos_id is not None:
            done0 = done0 | (first == s.eos_id)
        state.lengths[slot] = length
        state.cur_tokens[slot] = first
        state.n_generated[slot] = 1
        state.max_new[slot] = req_max_new
        state.done[slot] = done0
        state.out_tokens[slot] = 0
        state.out_tokens[slot, 0] = first
        return kv, state

    # ------------------------------------------------------------------
    # host-side scheduler
    # ------------------------------------------------------------------

    @property
    def pending(self) -> int:
        """Requests not yet fully retired (queued + live)."""
        return len(self._pending) + len(self._live)

    @property
    def recompile_ok(self) -> bool:
        return self.sentry.steady_recompiles == 0

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def stalled(self) -> bool:
        return self._stalled

    # ------------------------------------------------------------------
    # overload control
    # ------------------------------------------------------------------

    def projected_queue_wait_s(self) -> Optional[float]:
        """The queue wait a NEWLY queued request is projected to see:
        queue_depth × mean per-request service time / n_slots.  None
        until a request has retired."""
        if self.telemetry is None:
            return None
        svc = self.telemetry.ledger.service.mean
        if svc is None:
            return None
        return len(self._pending) * svc / max(1, self.serve_cfg.n_slots)

    @property
    def overloaded(self) -> bool:
        """The backpressure signal: True when the bounded queue is at
        capacity, or when the SLO projection says a new arrival's queue
        wait would breach `slo.max_queue_wait_ms`."""
        s = self.serve_cfg
        if (s.max_queue_depth is not None
                and len(self._pending) >= s.max_queue_depth):
            return True
        if self.slo is not None and self.slo.max_queue_wait_ms is not None:
            proj = self.projected_queue_wait_s()
            if proj is not None and 1e3 * proj > self.slo.max_queue_wait_ms:
                return True
        return False

    def _shed_victim(self, incoming: _Request) -> _Request:
        victim = choose_shed_victim(list(self._pending) + [incoming],
                                    self.serve_cfg.shed_policy)
        if victim is not incoming:
            self._pending.remove(victim)
        return victim

    def _shed(self, req: _Request, now: float) -> None:
        if self.telemetry is not None:
            self.telemetry.ledger.on_shed(req.rid, now)
        self._finished.append(FinishedRequest(
            request_id=req.rid, prompt=req.prompt, tokens=[],
            status="shed"))
        self.last_shed_rid = req.rid

    def _expire_queued(self, req: _Request, now: float) -> None:
        if self.telemetry is not None:
            self.telemetry.ledger.on_expire(req.rid, now, n_tokens=0,
                                            where="queue")
        self._finished.append(FinishedRequest(
            request_id=req.rid, prompt=req.prompt, tokens=[],
            status="expired"))

    def _sweep_expired_queue(self, now: float) -> int:
        """Evict every queued request whose deadline has passed (no
        pages were ever reserved for these)."""
        if not any(r.deadline_t is not None for r in self._pending):
            return 0
        keep, dropped = [], 0
        for req in self._pending:
            if req.expired(now):
                self._expire_queued(req, now)
                dropped += 1
            else:
                keep.append(req)
        if dropped:
            self._pending = collections.deque(keep)
        return dropped

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               deadline_ms: Optional[float] = None) -> int:
        """Queue a request; returns its request id.  `deadline_ms` is a
        TTL from NOW (terminal state `expired` once it passes, pages
        released either way).  With a bounded queue at capacity — or
        an attached SLO whose queue-wait projection says a new arrival
        would breach — the shed policy picks a victim (possibly this
        request), which ends `shed`; `last_shed_rid` names it for the
        duration of this call."""
        s = self.serve_cfg
        if self._draining:
            raise RuntimeError("submit() during drain(): admission is "
                               "stopped — this engine is shutting down")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > s.max_prompt_len:
            raise ValueError(
                f"prompt length {len(prompt)} > max_prompt_len "
                f"{s.max_prompt_len}")
        vocab = self.model_cfg.vocab_size
        if min(prompt) < 0 or max(prompt) >= vocab:
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        if not 1 <= max_new_tokens <= s.max_new_cap:
            raise ValueError(
                f"max_new_tokens {max_new_tokens} not in "
                f"[1, {s.max_new_cap}]")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0 (or None), got {deadline_ms}")
        # reject requests NO future state can admit — queueing one would
        # spin the engine forever behind a head-of-line request
        need = self.kv_config.pages_for(len(prompt) + max_new_tokens)
        ceiling = min(self.kv_config.pages_per_slot_max,
                      self.kv_config.usable_pages)
        if need > ceiling:
            raise ValueError(
                f"request needs {need} pages (prompt {len(prompt)} + "
                f"max_new {max_new_tokens} at page_size "
                f"{self.kv_config.page_size}) but this deployment can "
                f"ever serve at most {ceiling} per request")
        now = time.perf_counter()
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(
            rid=rid, prompt=prompt, max_new=int(max_new_tokens),
            submit_t=now,
            deadline_t=(now + deadline_ms / 1e3
                        if deadline_ms is not None else None),
            deadline_ms=deadline_ms)
        if self.telemetry is not None:
            self.telemetry.ledger.on_submit(
                rid, len(prompt), int(max_new_tokens), now,
                deadline_ms=deadline_ms)
        self.last_shed_rid = None
        # expired queue entries are dead weight — drop them BEFORE
        # judging capacity
        self._sweep_expired_queue(now)
        if self.overloaded:
            victim = self._shed_victim(req)
            self._shed(victim, now)
            if victim is req:
                return rid
        self._pending.append(req)
        return rid

    @torch.inference_mode()
    def cancel(self, request_id: int) -> bool:
        """Cancel a request by id.  Queued: removed outright (terminal
        `cancelled`, surfaced through `poll()`).  Mid-generation: the
        slot's `done` flag is set — a VALUE edit, the step's shapes
        never change — and the next retire poll retires it with the
        tokens generated so far.  Returns True when the request was
        found live or queued; False for an unknown or already-terminal
        id."""
        for req in self._pending:
            if req.rid == request_id:
                self._pending.remove(req)
                if self.telemetry is not None:
                    self.telemetry.ledger.on_cancel(
                        request_id, time.perf_counter(), n_tokens=0,
                        where="queue")
                self._finished.append(FinishedRequest(
                    request_id=request_id, prompt=req.prompt, tokens=[],
                    status="cancelled"))
                return True
        for slot, req in self._live.items():
            if req.rid == request_id:
                if self._evict_status.get(slot) == "cancelled":
                    return False           # already cancelled, in flight
                self._evict_status[slot] = "cancelled"
                self.state.done[slot] = True
                return True
        return False

    def _try_admit(self) -> int:
        """Admit queued requests into free slots while pages last.
        FIFO head-of-line: a request that doesn't fit blocks the queue.
        Deadline-expired entries are swept first."""
        admitted = 0
        self._sweep_expired_queue(time.perf_counter())
        while self._pending and self._free_slots:
            req = self._pending[0]
            slot = self._free_slots[-1]
            row = self.cache.allocate_slot(
                slot, len(req.prompt) + req.max_new)
            if row is None:
                break                      # pool exhausted — retry later
            self._pending.popleft()
            self._free_slots.pop()
            self._live[slot] = req
            # admit stamp = the scheduler's decision moment, BEFORE the
            # prefill: queue wait measures time in the queue
            if self.telemetry is not None:
                self.telemetry.ledger.on_admit(req.rid, slot,
                                               time.perf_counter())
                self._awaiting_first.append(req.rid)
            self.state = self.state._replace(
                block_table=self.cache.device_table())
            padded = np.zeros((self.serve_cfg.max_prompt_len,), np.int32)
            padded[:len(req.prompt)] = req.prompt
            self.kv, self.state = self._prefill_fn(
                self.params, self.kv, self.state, slot,
                torch.tensor(padded, device=self.device), len(req.prompt),
                req.max_new)
            self.prefills += 1
            admitted += 1
        return admitted

    def _retire_finished(self) -> int:
        """The scheduler's ONLY steady-state device reads: the done
        flags, plus counts and output rows when a slot finishes.
        Returns the number of slots vacated — normal retirements PLUS
        deadline evictions and cancellations.  Finishing tokens are
        validated against the vocab first: garbage ids raise
        `PoisonedOutputError` with the engine untouched."""
        if not self._live:
            return 0
        done = self.state.done.cpu().numpy()
        # ^ that fetch is the engine's steady-state sync point: it waits
        # for every previously launched step (the admitting prefills and
        # their decode included), so the host clock NOW bounds the
        # device-side truth and the lifecycle stamps below cost no
        # extra sync
        now = time.perf_counter()
        if self.telemetry is not None and self._awaiting_first:
            self.telemetry.ledger.on_first_token(self._awaiting_first, now)
            self._awaiting_first = []
        expired = [s for s, req in self._live.items()
                   if not done[s] and req.expired(now)]
        if not done.any() and not expired:
            return 0
        n_gen = self.state.n_generated.cpu().numpy()
        out_tok = self.state.out_tokens.cpu().numpy()
        leaving = [s for s in sorted(self._live)
                   if done[s] or s in expired]
        vocab = self.model_cfg.vocab_size
        for slot in leaving:
            toks = out_tok[slot, :int(n_gen[slot])]
            if toks.size and (int(toks.min()) < 0
                              or int(toks.max()) >= vocab):
                rid = self._live[slot].rid
                raise PoisonedOutputError(
                    f"slot {slot} (request {rid}) finished with token "
                    f"ids outside [0, {vocab}) at step "
                    f"{self.steps_completed} — the decode plane "
                    "emitted garbage; restart from the last good "
                    "snapshot", slot=slot, request_id=rid,
                    step=self.steps_completed)
        for slot in leaving:
            req = self._live.pop(slot)
            n = int(n_gen[slot])
            toks = out_tok[slot, :n].tolist()
            if done[slot]:
                status = self._evict_status.pop(slot, "ok")
            else:
                status = "expired"
                self._evict_status.pop(slot, None)
            self._finished.append(
                FinishedRequest(request_id=req.rid, prompt=req.prompt,
                                tokens=toks, status=status))
            if self.telemetry is not None:
                led = self.telemetry.ledger
                if status == "ok":
                    led.on_retire(req.rid, n, now)
                elif status == "cancelled":
                    led.on_cancel(req.rid, now, n_tokens=n, where="live")
                else:
                    led.on_expire(req.rid, now, n_tokens=n, where="live")
            self.cache.release_slot(slot)
            self._free_slots.append(slot)
        idx = torch.tensor(leaving, dtype=torch.long, device=self.device)
        self.state.lengths[idx] = 0
        self.state.n_generated[idx] = 0
        self.state.done[idx] = False
        return len(leaving)

    @torch.inference_mode()
    def step(self):
        """One engine iteration: retire → admit → decode-all-slots.
        Returns (admitted, retired) counts so callers can tell churn
        steps from pure decode steps.  A step that made retire-poll
        progress bumps `steps_completed`.  The `serve.stall_step` chaos
        point wedges the engine (no poll, no progress, forever)."""
        if self._stalled or _chaos.fire("serve.stall_step"):
            self._stalled = True
            return 0, 0
        retired = self._retire_finished()
        admitted = 0 if self._draining else self._try_admit()
        if not self._live:
            # fully drained: skip the all-inactive decode forward
            self.steps_completed += 1
            if self.telemetry is not None:
                self.telemetry.note_step(admitted, retired, self.gauges())
            return admitted, retired
        out = self.sentry(self.params, self.kv, self.state)
        if self.serve_cfg.emit_logits:
            self.kv, self.state, self.last_logits = out
        else:
            self.kv, self.state = out
        if _chaos.fire("serve.poison_logits"):
            # every live slot's output ring turns to garbage ids,
            # detected (by name) when one finishes
            live = torch.tensor(sorted(self._live), dtype=torch.long,
                                device=self.device)
            self.state.out_tokens[live] = -1
        self.steps_completed += 1
        # first call that saw no new signature = warmup over; the cap
        # forces steady so a step that changes signature every call has
        # its changes COUNTED
        if not self._steady:
            just_compiled = (
                self.sentry.events
                and self.sentry.events[-1]["call"] == self.sentry.calls)
            if (not just_compiled
                    or self.sentry.calls >= _STEADY_WARMUP_CAP):
                self.sentry.mark_steady()
                self._steady = True
        if self.telemetry is not None:
            self.telemetry.note_step(admitted, retired, self.gauges())
        return admitted, retired

    @torch.inference_mode()
    def run(self, max_steps: int = 10_000) -> List[FinishedRequest]:
        """Drive until every submitted request retired; returns them in
        completion order."""
        steps = 0
        while self.pending:
            if steps >= max_steps:
                raise RuntimeError(
                    f"run(): {self.pending} request(s) still live after "
                    f"{max_steps} steps")
            self.step()
            steps += 1
        self._retire_finished()
        return self.poll()

    def poll(self) -> List[FinishedRequest]:
        out, self._finished = self._finished, []
        return out

    @torch.inference_mode()
    def drain(self, max_steps: int = 10_000) -> dict:
        """Graceful shutdown: STOP admission, run the live slots to
        completion, and return a restorable `state_dict()` snapshot
        (still-queued requests ride in it).  Finished results remain
        available via `poll()`.  The `serve.kill_mid_drain` chaos point
        kills the loop partway."""
        self._draining = True
        try:
            steps = 0
            while self._live:
                _chaos.check("serve.kill_mid_drain")
                if steps >= max_steps:
                    raise RuntimeError(
                        f"drain(): {len(self._live)} slot(s) still live "
                        f"after {max_steps} steps")
                self.step()
                steps += 1
            return self.state_dict()
        finally:
            self._draining = False

    def stats(self) -> dict:
        return {
            "n_slots": self.serve_cfg.n_slots,
            "live": len(self._live),
            "queued": len(self._pending),
            "free_pages": self.cache.free_pages,
            "pool_bytes": self.kv_config.pool_bytes(),
            "recompile_ok": self.recompile_ok,
            "sentry": self.sentry.summary(),
            "draining": self._draining,
            "stalled": self._stalled,
            "steps_completed": self.steps_completed,
        }

    # ------------------------------------------------------------------
    # serving observatory readers
    # ------------------------------------------------------------------

    def gauges(self) -> dict:
        """Instantaneous scheduler/pool gauges — host-side values the
        scheduler already owns, zero device traffic."""
        cfg = self.kv_config
        used = cfg.usable_pages - self.cache.free_pages
        mqd = self.serve_cfg.max_queue_depth
        return {
            "slots_live": len(self._live),
            "slots_free": len(self._free_slots),
            "queue_depth": len(self._pending),
            "pages_free": self.cache.free_pages,
            "pages_used": used,
            "pool_util": used / max(1, cfg.usable_pages),
            "queue_saturation": (len(self._pending) / mqd
                                 if mqd else 0.0),
        }

    def serve_record(self) -> dict:
        """Flat `serve_*` JSON scalars: live gauges always, ledger
        percentiles once samples exist, the watchdog's stall and restart
        counts once one is attached, `serve_slo_ok` when an SLO is
        attached and its verdict is grounded."""
        if self.telemetry is None:
            return {}
        rec = self.telemetry.serve_record()
        if self.watchdog is not None:
            rec["serve_watchdog_stalls"] = int(self.watchdog.stalls)
            rec["serve_watchdog_restarts"] = int(self.watchdog.restarts)
        if self.slo is not None:
            v = self.slo_verdict()
            # a green stamps only once every configured axis has
            # samples; an idle engine's all-skipped "ok" is unmeasured
            if v.grounded:
                rec["serve_slo_ok"] = bool(v.ok)
        return rec

    def slo_verdict(self, slo=None):
        """Evaluate `slo` (default: the engine's attached ServeSLO)
        against the live telemetry."""
        slo = slo if slo is not None else self.slo
        if slo is None:
            raise ValueError("slo_verdict: no ServeSLO attached or given")
        if self.telemetry is None:
            raise ValueError("slo_verdict: engine built telemetry=False")
        return slo.evaluate(self.telemetry)

    def telemetry_report(self) -> Optional[dict]:
        """The full JSON-safe observatory dict (ledger summary and tail,
        gauges and peaks, step counters, the engine's `stats()`, the
        SLO and its verdict when one is attached); None when the engine
        was built with telemetry=False."""
        if self.telemetry is None:
            return None
        rep = self.telemetry.report()
        rep["stats"] = self.stats()
        if self.slo is not None:
            rep["slo"] = self.slo.to_dict()
            rep["slo_verdict"] = self.slo_verdict().to_dict()
        return rep

    # ------------------------------------------------------------------
    # snapshot / preemption resume
    # ------------------------------------------------------------------

    # scheduler entries carry submit AGE and REMAINING deadline
    # (perf_counter absolutes are process-relative) plus the finished
    # list's terminal statuses; the JAX package's version 2
    _SERVE_STATE_VERSION = 2

    def _deployment_fingerprint(self) -> dict:
        """The static knobs that fix the step's shapes — a snapshot
        only restores into the SAME deployment."""
        c, s, k = self.model_cfg, self.serve_cfg, self.kv_config
        return {"n_slots": s.n_slots, "max_prompt_len": s.max_prompt_len,
                "max_new_cap": s.max_new_cap, "eos_id": s.eos_id,
                "page_size": k.page_size, "n_pages": k.n_pages,
                "n_layers": c.num_layers, "hidden": c.hidden,
                "num_heads": c.num_heads, "vocab_size": c.vocab_size,
                # dtypes are part of the deployment: a cross-dtype
                # restore would silently cast the KV pool
                "cache_dtype": str(k.dtype).replace("torch.", ""),
                "model_dtype": str(c.dtype).replace("torch.", "")}

    def state_dict(self) -> dict:
        """Host snapshot of EVERYTHING a preempted serving node needs
        to resume mid-generation: the paged KV pool (CPU tensors), the
        per-slot DecodeState (numpy), the allocator, and the scheduler
        queues.  The weights are deliberately NOT included.  Restore
        into a FRESH engine of the same deployment via
        `load_state_dict` and decoding continues bitwise where it left
        off."""
        snap_t = time.perf_counter()

        def pack(req: _Request) -> list:
            # submit age + remaining deadline (may be negative: already
            # expired, and it expires immediately on resume)
            return [req.rid, list(req.prompt), req.max_new,
                    snap_t - req.submit_t,
                    (req.deadline_t - snap_t
                     if req.deadline_t is not None else None),
                    req.deadline_ms]

        return {
            "serve_state_version": self._SERVE_STATE_VERSION,
            "deployment": self._deployment_fingerprint(),
            "kv": {k: v.cpu().clone() for k, v in self.kv.items()},
            "decode_state": {k: v.cpu().numpy().copy()
                             for k, v in self.state._asdict().items()},
            "cache": self.cache.state_dict(),
            "scheduler": {
                "next_rid": self._next_rid,
                "pending": [pack(r) for r in self._pending],
                "free_slots": list(self._free_slots),
                "live": {int(s): pack(r)
                         for s, r in self._live.items()},
                "evict_status": {int(s): st for s, st
                                 in self._evict_status.items()},
                "finished": [[f.request_id, list(f.prompt),
                              list(f.tokens), f.status]
                             for f in self._finished],
            },
        }

    @torch.inference_mode()
    def load_state_dict(self, d: dict) -> None:
        """Inverse of state_dict into a fresh engine of the SAME
        deployment (the fingerprint is validated field by field)."""
        ver = d.get("serve_state_version")
        if ver != self._SERVE_STATE_VERSION:
            raise ValueError(
                f"serve_state_version {ver!r} != "
                f"{self._SERVE_STATE_VERSION}")
        want = self._deployment_fingerprint()
        got = d.get("deployment") or {}
        bad = [k for k in want if got.get(k) != want[k]]
        if bad:
            raise ValueError(
                "DecodeEngine.load_state_dict: snapshot is from a "
                "different deployment — mismatched " + ", ".join(
                    f"{k} (snapshot {got.get(k)!r} != engine "
                    f"{want[k]!r})" for k in bad))
        cfg = self.kv_config
        self.kv = {k: torch.as_tensor(v).to(device=self.device,
                                            dtype=cfg.dtype, copy=True)
                   for k, v in d["kv"].items()}
        self.state = DecodeState(**{
            k: torch.tensor(np.asarray(v), device=self.device)
            for k, v in d["decode_state"].items()})
        self.cache.load_state_dict(d["cache"])
        sch = d["scheduler"]
        now = time.perf_counter()

        def unpack(entry) -> _Request:
            rid, p, mn, age, remaining, dl_ms = entry
            return _Request(
                rid=int(rid), prompt=[int(t) for t in p],
                max_new=int(mn), submit_t=now - float(age),
                deadline_t=(now + float(remaining)
                            if remaining is not None else None),
                deadline_ms=(float(dl_ms) if dl_ms is not None
                             else None))

        self._next_rid = int(sch["next_rid"])
        self._pending = collections.deque(
            unpack(e) for e in sch["pending"])
        self._free_slots = [int(s) for s in sch["free_slots"]]
        self._live = {int(s): unpack(e) for s, e in sch["live"].items()}
        self._evict_status = {int(s): str(st) for s, st
                              in sch.get("evict_status", {}).items()}
        self._finished = [
            FinishedRequest(request_id=int(rid), prompt=[int(t) for t in p],
                            tokens=[int(t) for t in toks],
                            status=str(status))
            for rid, p, toks, status in sch["finished"]]
        self._draining = False
        self._stalled = False
        # the ledger is RESTORE-scoped: rebuilt fresh, with the restored
        # requests re-registered — queued ones as fresh submissions,
        # in-flight ones marked `restored` so they count in totals
        # without feeding resume-relative deltas into the estimators
        self._awaiting_first = []
        if self.telemetry is not None:
            old = self.telemetry
            self.telemetry = ServeTelemetry(
                tail_cap=old.ledger.tail.maxlen,
                estimator_capacity=old.ledger.ttft.capacity,
                step_time_warmup=old._step_time_warmup)
            led = self.telemetry.ledger
            for req in self._pending:
                led.reopen_restored(req.rid, len(req.prompt),
                                    req.max_new, now,
                                    submit_t=req.submit_t,
                                    deadline_ms=req.deadline_ms)
            for slot, req in self._live.items():
                led.reopen_restored(req.rid, len(req.prompt),
                                    req.max_new, now, slot=slot,
                                    submit_t=req.submit_t,
                                    deadline_ms=req.deadline_ms)


def _sync(eng: DecodeEngine) -> None:
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


@torch.inference_mode()
def measure_decode(eng: DecodeEngine, *, warm: int = 2,
                   max_steps: Optional[int] = None,
                   stop=None) -> dict:
    """Drive a loaded engine to completion and measure it — the one
    timing convention of the JAX package's `measure_decode`.

    Per-step wall time synchronizes the device INSIDE the timed region:
    CUDA launches return before the device finishes, so an unsynced
    timer records host launch time while the real decode runs under
    the NEXT step's first device fetch.

    Returns a dict:
      finished        every FinishedRequest, completion order
      per_step_s      raw per-step seconds (head includes warmup)
      steps / churn_steps / pure_decode_steps
      tokens_per_sec  tokens ACTUALLY emitted post-warmup / window
                      seconds
      p50_ms / p99_ms per-token latency over PURE decode steps
                      (admission/retirement steps excluded; when there
                      are none they fall back, with a warning, to every
                      post-warmup step)
      admitted / retired  summed step() accounting
      ledger          the engine's ledger summary (None when the
                      engine was built telemetry=False)
      recompile_ok    the sentry verdict
      stopped         True when `stop` ended the drive early

    `stop=` is a zero-arg callable polled BETWEEN steps once at least
    one step has been measured; returning True ends the drive with
    work still pending (then hand the remainder to `drain()`).
    """
    if not eng.pending:
        raise ValueError("measure_decode: engine has no pending "
                         "requests — submit before measuring")
    per_step, churn, cum_tokens = [], [], []
    finished: List[FinishedRequest] = []
    polled_tokens = 0
    n_admitted = n_retired = 0
    stopped = False
    while eng.pending:
        if stop is not None and per_step and stop():
            stopped = True           # graceful early exit, between steps
            break
        if max_steps is not None and len(per_step) >= max_steps:
            raise RuntimeError(
                f"measure_decode: {eng.pending} request(s) still live "
                f"after {max_steps} steps")
        t0 = time.perf_counter()
        admitted, retired = eng.step()
        _sync(eng)
        dt = time.perf_counter() - t0
        per_step.append(dt)
        churned = bool(admitted or retired)
        churn.append(churned)
        n_admitted += admitted
        n_retired += retired
        if eng.telemetry is not None:
            eng.telemetry.record_step_time(dt, churned, warmup=warm)
        fins = eng.poll()
        finished.extend(fins)
        polled_tokens += sum(len(f.tokens) for f in fins)
        cum_tokens.append(
            polled_tokens + int(eng.state.n_generated.sum()))
    # the last step retires the final cohort at ITS start; drain any
    # stragglers the loop exit left unpolled
    n_retired += eng._retire_finished()
    finished.extend(eng.poll())
    w = min(warm, len(per_step) - 1)        # w <= len-1: never empty
    window = per_step[w:]
    win_tokens = int(np.diff([0] + cum_tokens)[w:].sum())
    pct = step_latency_percentiles(per_step, churn, warm=warm)
    if not pct["pure_decode_steps"]:
        import warnings
        warnings.warn(
            "measure_decode: no pure decode step in the measurement "
            "window; p50/p99 include admission/retirement work",
            stacklevel=2)
    return {
        "finished": finished,
        "per_step_s": per_step,
        "churn": churn,
        "steps": len(per_step),
        "churn_steps": int(sum(churn)),
        "pure_decode_steps": pct["pure_decode_steps"],
        "tokens_per_sec": win_tokens / sum(window),
        "p50_ms": pct["p50_ms"],
        "p99_ms": pct["p99_ms"],
        "admitted": n_admitted,
        "retired": n_retired,
        "ledger": (eng.telemetry.ledger.summary()
                   if eng.telemetry is not None else None),
        "recompile_ok": eng.recompile_ok,
        "stopped": stopped,
    }


def flagship_n_slots(on_gpu: bool) -> int:
    """The flagship slot-count policy — 64 on the card, 8 for the CPU
    smoke configuration."""
    return 64 if on_gpu else 8


def build_flagship_engine(n_slots: Optional[int] = None, seed: int = 0,
                          recorder=None, params=None,
                          serve_overrides: Optional[dict] = None,
                          device=None) -> DecodeEngine:
    """The flagship serving setup.  On the card (the default device):
    GPT-350M (vocab 50304, seq 1024, hidden 1024, 24 layers, 16 heads of
    64) in bf16 with random weights from `init_gpt_params(seed)`, 64
    slots, prompts up to 128 tokens and up to 128 new ones, pages of
    128 tokens.  With `device="cpu"` the JAX package's CPU smoke
    configuration substitutes through the same build path.  Raises
    when CUDA is asked for (by default) and absent.

    `params=` reuses an already-initialized weight dict; `n_slots=None`
    takes `flagship_n_slots`; `serve_overrides=` replaces ServeConfig
    fields on top of the flagship defaults; `recorder=` a
    `monitor.trace.FlightRecorder` the engine's sentry pushes its
    compile events to and whose dumps carry the engine's telemetry."""
    from apex_tpu_torch.models.gpt import GPTConfig, init_gpt_params

    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    if n_slots is None:
        n_slots = flagship_n_slots(on_gpu)
    if on_gpu:
        cfg = GPTConfig(vocab_size=50304, seq_len=1024, hidden=1024,
                        num_layers=24, num_heads=16, dropout=0.0,
                        dtype=torch.bfloat16)
        sc = ServeConfig(n_slots=n_slots, max_prompt_len=128,
                         max_new_cap=128)
    else:
        cfg = GPTConfig(vocab_size=512, seq_len=64, hidden=64,
                        num_layers=2, num_heads=4, dropout=0.0)
        sc = ServeConfig(n_slots=n_slots, max_prompt_len=16,
                         max_new_cap=16, page_size=8)
    if serve_overrides:
        sc = dataclasses.replace(sc, **serve_overrides)
    if params is None:
        params = init_gpt_params(cfg, seed, dev)
    return DecodeEngine(cfg, params, sc, recorder=recorder, device=dev)
