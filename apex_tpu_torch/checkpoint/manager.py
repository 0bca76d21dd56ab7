"""`CheckpointManager`: async ZeRO-sharded snapshots off the hot path
(counterpart of apex_tpu/checkpoint/manager.py).

The training loop calls ``manager.maybe_save(step, opt_state, scaler)``
between steps.  On a cadence hit the manager

1. waits for the PREVIOUS write to commit (at most one write is ever in
   flight; a save landing while the previous one is still writing
   blocks, and that wait is priced in `ckpt_blocking_s`);
2. snapshots the state device→host: every copy is issued
   `non_blocking` into one set of pinned host buffers, kept and reused,
   then one synchronisation, and only then does `save()` return (the
   optimizers update their buffers in place, so the copy must land
   before the next step writes them); each field splits by the
   optimizer's ``state_partition_specs()`` into per-rank shards or one
   replicated array;
3. hands the host snapshot to a background writer thread that runs the
   `sharded.save_sharded` commit protocol (shards first, manifest
   rename last) and prunes old steps.  The writer touches only the host
   buffers: it makes no CUDA call and no `torch.distributed` call.

`ckpt_blocking_s` (what the hot path paid, the copy included) and
`ckpt_save_s` (what the writer thread paid) land in `stats()`.

Ranks.  A port rank holds only its own shard of a ZeRO state.  With the
optimizer's group at one rank the manager takes the single-process
path.  Above one rank each rank is one process of the multi-host
protocol (`checkpoint.multihost`): `process_id` is its rank in the
optimizer's group, `num_processes` the group's size, `local_ranks`
``[rank]``; rank 0 alone writes the replicated fields (`step`, the
model state, the scaler) and commits, and the committed manifest is
the one a single-controller save of the same state writes.  Passing
``process_id`` / ``num_processes`` / ``local_ranks`` (or the launcher's
``APEX_TPU_*`` variables, for an optimizer without a group) runs the
JAX package's multi-host mode instead, where a state holds the global
buffers and each host writes its local ranks' slices.

States cut over tp or pp.  `make_tp_dp_train_step`'s state (and so
`GPTPipelined`'s) holds on each rank its pp and tp shard of the flat
buffers: the rank at stage pp_i and tp rank tp_i holds row
pp_i·tp + tp_i of the JAX package's ``P(("pp", "tp"))`` state buffer.
`save()` gathers every field but `step` over the mesh's (pp, tp) group
on the training thread (`parallel.mesh.all_gather`, so the comms
inventory sees it), pp-major, into that global buffer, and writes it
as the JAX manager does: one ``"replicated"`` field.  One process
writes alone; above one rank, global rank 0 writes the replicated
fields and commits behind the multi-host file barrier, with no host
record, so the manifest is the one the JAX package's single-controller
save writes.  `restore()` hands each rank its row of each such field.

Model state outside the optimizer (RNG key, BN running stats) rides
the same commit: ``model_state={"rng_key": key, ...}`` to
`save`/`maybe_save`, read back with `restore_model_state()`.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

import torch

from apex_tpu_torch.checkpoint import sharded as S
from apex_tpu_torch.parallel import mesh as M


def _plane():
    """The mesh's (pp, tp) group (None without a mesh or without
    torch.distributed): the ranks a `make_tp_dp_train_step` state is cut
    over, in row order."""
    return M.group_of((M.PP_AXIS, M.TP_AXIS))


def _cut():
    """(row, pp, tp): this rank's row in the mesh's (pp, tp) plane and
    the plane's shape; None without a mesh."""
    plane = _plane()
    if plane is None:
        return None
    return (M.group_rank(plane), M.group_size(M.group_of(M.PP_AXIS)),
            M.group_size(M.group_of(M.TP_AXIS)))


class CheckpointManager:
    """directory: checkpoint root (``step_{k}/`` subdirs).  optimizer:
    the live optimizer instance; a ZeRO optimizer's
    ``state_partition_specs()`` / ``shard_layout()`` drive the shard
    split, a plain flat optimizer checkpoints replicated.  keep: how
    many committed steps survive pruning.  async_write=False runs the
    writer inline (the chaos tests' deterministic mode)."""

    def __init__(self, directory: str, optimizer=None, *,
                 every_n_steps: int = 100, keep: int = 2,
                 axis_name=None, async_write: bool = True,
                 process_id: Optional[int] = None,
                 num_processes: Optional[int] = None,
                 local_ranks=None, attempt: Optional[int] = None,
                 barrier_timeout_s: float = 120.0):
        if every_n_steps < 1:
            raise ValueError(
                f"every_n_steps must be >= 1, got {every_n_steps}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.optimizer = optimizer
        self.every_n_steps = every_n_steps
        self.keep = keep
        self.axis_name = axis_name or getattr(optimizer, "axis_name",
                                              None) or M.DP_AXIS
        self.async_write = async_write
        # a port ZeRO optimizer over a group above one rank: each rank is
        # one process of the multi-host protocol, unless the caller names
        # the processes itself
        self._rank_of = getattr(optimizer, "_rank", None)
        num = int(getattr(optimizer, "num_shards", 1) or 1)
        self._group_ranks = (self._rank_of is not None and num > 1
                             and process_id is None
                             and num_processes is None
                             and local_ranks is None)
        if self._group_ranks:
            process_id, num_processes = self._rank_of(), num
            local_ranks = [process_id]
        # a state cut over tp or pp ranks: each rank of the world is one
        # process of the multi-host protocol, global rank 0 commits
        self._mp_ranks = (not self._group_ranks and process_id is None
                          and num_processes is None and local_ranks is None
                          and M.group_size(_plane()) > 1)
        if self._mp_ranks:
            import torch.distributed as dist
            process_id, num_processes = dist.get_rank(), dist.get_world_size()
            local_ranks = []
        # each id falls back to the launcher's env independently
        if num_processes is None:
            num_processes = int(os.environ.get(
                "APEX_TPU_NUM_PROCESSES", "1") or 1)
        if process_id is None:
            process_id = int(os.environ.get(
                "APEX_TPU_PROCESS_ID", "0") or 0)
        self.num_processes = int(num_processes)
        self.process_id = int(process_id)
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(
                f"process_id {self.process_id} outside "
                f"[0, {self.num_processes})")
        self.local_ranks = (None if local_ranks is None
                            else sorted(int(r) for r in local_ranks))
        self.attempt = attempt  # None: resolved from APEX_TPU_ATTEMPT
        self.barrier_timeout_s = barrier_timeout_s
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._last_requested: Optional[int] = None
        self._stats: Dict[str, Any] = {}
        self._host: Dict[str, torch.Tensor] = {}   # the kept host buffers

    @property
    def multihost(self) -> bool:
        return self.num_processes > 1

    def _resolve_attempt(self) -> int:
        if self.attempt is not None:
            return int(self.attempt)
        return int(os.environ.get("APEX_TPU_ATTEMPT", "0") or 0)

    def _resolve_local_ranks(self, num_shards: int):
        from apex_tpu_torch.checkpoint import multihost as MH
        if self.local_ranks is not None:
            return self.local_ranks
        return MH.local_ranks(self.process_id, self.num_processes,
                              num_shards)

    # ------------------------------------------------------------------
    # save path
    # ------------------------------------------------------------------

    def maybe_save(self, step: int, opt_state, scaler_state=None,
                   extra: Optional[dict] = None,
                   model_state: Optional[dict] = None) -> bool:
        """Save iff `step` is on the cadence (and not already saved).
        Returns whether a save was started; `wait()` blocks until it
        commits."""
        step = int(step)
        if step == self._last_requested or step % self.every_n_steps:
            return False
        self.save(step, opt_state, scaler_state, extra=extra,
                  model_state=model_state)
        return True

    def save(self, step: int, opt_state, scaler_state=None, *,
             extra: Optional[dict] = None,
             model_state: Optional[dict] = None) -> None:
        """Unconditional save of `step`.  Blocking cost: the wait for the
        previous write and the device→host snapshot; the file I/O runs
        on the writer thread.  `model_state`: a (nested) dict of
        replicated arrays committed in the same manifest (written by
        process 0 only)."""
        t0 = time.perf_counter()
        self.wait()  # double buffer: at most one write in flight
        fields = self._snapshot(opt_state, model_state)
        scaler = None
        if scaler_state is not None:
            from apex_tpu_torch.amp import scaler as scaler_lib
            scaler = scaler_lib.state_dict(scaler_state)
        # a cut save records its (pp, tp) in the ranks' sub-manifests,
        # the port's own files, so a restore at another cut is refused
        cut = None
        if self._mp_ranks:
            _, pp, tp = _cut()
            cut = {"pp": pp, "tp": tp}
        layout = None
        if self.optimizer is not None and hasattr(self.optimizer,
                                                  "shard_layout"):
            layout = self.optimizer.shard_layout()
        from apex_tpu_torch import tune
        fingerprint = tune.fingerprint()
        blocking = time.perf_counter() - t0
        self._last_requested = int(step)
        total = sum(
            sum(int(a.nbytes) for a in
                (v.values() if isinstance(v, dict) else v))
            if kind == "sharded" else int(v.nbytes)
            for kind, v in fields.values())

        def _write():
            t1 = time.perf_counter()
            try:
                if self.multihost:
                    from apex_tpu_torch.checkpoint import multihost as MH
                    _, barrier_s = MH.save_sharded_multihost(
                        self.directory, step, fields,
                        process_id=self.process_id,
                        num_processes=self.num_processes,
                        attempt=self._resolve_attempt(),
                        flat_layout=layout, scaler=scaler,
                        tuner_fingerprint=fingerprint, extra=extra,
                        timeout_s=self.barrier_timeout_s,
                        record_hosts=not (self._group_ranks
                                          or self._mp_ranks),
                        cut=cut)
                else:
                    S.save_sharded(
                        self.directory, step, fields, flat_layout=layout,
                        scaler=scaler, tuner_fingerprint=fingerprint,
                        extra=extra, overwrite=True)
                # one update at commit time: every ckpt_* stat describes
                # the same save
                stats = dict(
                    ckpt_blocking_s=round(blocking, 6),
                    ckpt_save_s=round(time.perf_counter() - t1, 6),
                    ckpt_last_step=int(step),
                    ckpt_bytes=int(total))
                if self.multihost:
                    if self.process_id == 0:
                        # how long the commit barrier waited on the
                        # slowest host's sub-manifest
                        stats["ckpt_commit_barrier_s"] = round(
                            barrier_s, 6)
                    else:
                        # a non-zero host never observes the commit: its
                        # resume point is whatever disk says
                        lc = S.latest_committed_step(self.directory)
                        if lc is None:
                            stats.pop("ckpt_last_step")
                        else:
                            stats["ckpt_last_step"] = int(lc)
                self._stats.update(stats)
                # prune on process 0 only: hosts racing rmtree over a
                # shared store would tear each other's sweeps apart
                if not self.multihost or self.process_id == 0:
                    S.prune(self.directory, self.keep)
            except BaseException as e:
                self._error = e
                raise

        if self.async_write:
            # the failure surfaces on the training thread at the next
            # wait()/save()
            def _quiet():
                try:
                    _write()
                except BaseException:
                    pass  # kept in self._error, re-raised by wait()

            self._thread = threading.Thread(
                target=_quiet, name=f"ckpt-write-step{step}", daemon=True)
            self._thread.start()
        else:
            try:
                _write()
            except BaseException:
                # surfaced here, synchronously: a stale deferred copy
                # must not make the next save()'s wait() skip its write
                self._error = None
                raise

    def wait(self) -> None:
        """Block until the in-flight write (if any) committed; re-raise
        a writer-thread failure here, on the training thread."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _check_topology(self, specs) -> None:
        """A state cut over tp or pp ranks saves through `_snapshot`'s
        gather.  What this format cannot hold is a ZeRO state cut over
        them too: its dp shards differ from one (pp, tp) rank to the
        next, and a shard file is named by its dp rank alone.  That is
        refused by name."""
        n = M.group_size(_plane())
        dp_cut = [k for k, v in (specs or {}).items()
                  if v and self.axis_name in tuple(v)]
        if n > 1 and dp_cut:
            raise S.CheckpointError(
                f"CheckpointManager: the ZeRO fields {sorted(dp_cut)} are "
                f"sharded over {self.axis_name!r} and the state is cut over "
                f"{n} (pp, tp) ranks as well — the shard-native format "
                "records data-parallel shards of one flat state; "
                "checkpoint a ZeRO state at tp = pp = 1")

    def _to_host(self, name: str, v) -> torch.Tensor:
        """`v` copied into this field's kept host buffer (pinned for a
        card tensor), the copy issued `non_blocking`."""
        if not isinstance(v, torch.Tensor):
            return S.as_host(v).clone()
        buf = self._host.get(name)
        if (buf is None or buf.shape != v.shape or buf.dtype != v.dtype):
            buf = torch.empty(v.shape, dtype=v.dtype,
                              pin_memory=v.device.type == "cuda")
            self._host[name] = buf
        buf.copy_(v.detach(), non_blocking=v.device.type == "cuda")
        return buf

    def _host_shards(self, name: str, v: torch.Tensor, num: int):
        """{global rank: host array} of one sharded field: a port ZeRO
        optimizer's state is this rank's shard; the state of an optimizer
        without a group holds the global buffer, split into `num`."""
        if num == 1:
            return {0: v}
        if self._rank_of is not None:
            return {self._rank_of(): v}
        if v.shape[0] % num:
            raise S.CheckpointError(
                f"field {name!r}: global length {v.shape[0]} not "
                f"divisible by num_shards {num}")
        return dict(enumerate(torch.chunk(v, num)))

    def _snapshot(self, opt_state, model_state=None) -> Dict[str, tuple]:
        """Device→host copy, split per `state_partition_specs()`.  Above
        one process only this process's local ranks of the sharded
        fields are kept, and only process 0 keeps the replicated ones."""
        d = (opt_state._asdict() if hasattr(opt_state, "_asdict")
             else dict(opt_state))
        specs = None
        if self.optimizer is not None and hasattr(
                self.optimizer, "state_partition_specs"):
            specs = self.optimizer.state_partition_specs()
            specs = (specs._asdict() if hasattr(specs, "_asdict")
                     else dict(specs))
        self._check_topology(specs)
        num = int(getattr(self.optimizer, "num_shards", 1) or 1)
        writes_replicated = not self.multihost or self.process_id == 0
        sharded = {name: bool(specs and specs.get(name))
                   and self.axis_name in tuple(specs.get(name))
                   for name in d}
        plane = _plane()
        if plane is not None:
            # every field but `step` is cut over (pp, tp): this rank's
            # row of the JAX package's P(("pp", "tp")) buffer.  Gathered
            # here, on the training thread, pp-major
            n = M.group_size(plane)
            for name, v in list(d.items()):
                if (sharded.get(name) or name == "step"
                        or not isinstance(v, torch.Tensor) or v.dim() == 0):
                    continue
                v = v.detach().reshape(-1).contiguous()
                out = torch.empty(n * v.numel(), dtype=v.dtype,
                                  device=v.device)
                M.all_gather(out, v, plane)
                d[name] = out
        if model_state and writes_replicated:
            packed = S.pack_model_state(model_state)
            clash = set(packed) & set(d)
            if clash:
                raise S.CheckpointError(
                    f"model state collides with optimizer fields: "
                    f"{sorted(clash)}")
            d.update({n: v for n, (_, v) in packed.items()})
        # issue every copy, then synchronise once
        host = {name: self._to_host(name, v) for name, v in d.items()
                if sharded.get(name) or writes_replicated}
        cuda = [v for v in d.values()
                if isinstance(v, torch.Tensor) and v.device.type == "cuda"]
        if cuda:
            torch.cuda.current_stream(cuda[0].device).synchronize()
        local = (set(self._resolve_local_ranks(num)) if self.multihost
                 else None)
        fields: Dict[str, tuple] = {}
        for name, v in host.items():
            if not sharded.get(name):
                fields[name] = ("replicated", v)
                continue
            by_rank = self._host_shards(name, v, num)
            if local is None:
                if len(by_rank) != num:
                    raise S.CheckpointError(
                        f"field {name!r}: this process holds ranks "
                        f"{sorted(by_rank)} of {num}; a state sharded "
                        "over several ranks saves with one process a "
                        "rank")
                fields[name] = ("sharded",
                                [by_rank[r] for r in sorted(by_rank)])
            else:
                mine = {r: a for r, a in by_rank.items() if r in local}
                missing = local - set(mine)
                if missing:
                    raise S.CheckpointError(
                        f"field {name!r}: local ranks {sorted(missing)} "
                        "are not held by this process — local_ranks "
                        "does not match the state's placement")
                if mine:  # a host with zero ranks skips the field
                    fields[name] = ("sharded", mine)
        return fields

    # ------------------------------------------------------------------
    # restore / introspection
    # ------------------------------------------------------------------

    @property
    def last_committed_step(self) -> Optional[int]:
        """Ground truth from disk (a fresh manager after a crash reads
        the same answer the dying one would have)."""
        return S.latest_committed_step(self.directory)

    def restore(self, device=None, step: Optional[int] = None,
                verify_crc: bool = True):
        """`sharded.restore_sharded` against this manager's optimizer, on
        `device` (the card unless the caller asks for the CPU).  Under a
        mesh each rank takes its row pp_i·tp + tp_i of every field but
        `step`, and a save at another (pp, tp) cut is refused by name
        (`cut`).  Returns (state, scaler_state, manifest)."""
        if self.optimizer is None:
            raise S.CheckpointError(
                "CheckpointManager.restore needs the optimizer the "
                "state is being restored FOR (its init() fixes the "
                "target layout)")
        return S.restore_sharded(self.directory, self.optimizer,
                                 device=device, step=step,
                                 verify_crc=verify_crc, cut=_cut())

    def restore_model_state(self, step: Optional[int] = None, *,
                            verify_crc: bool = True) -> dict:
        """The ``model.*`` fields (RNG key, BN stats, …) of one committed
        step as a nested dict of CPU tensors ({} when it carries
        none).  Pair with `restore()` at the SAME step."""
        return S.load_model_state(self.directory, step,
                                  verify_crc=verify_crc)

    def stats(self) -> Dict[str, Any]:
        """The `ckpt_*` telemetry scalars of the newest save (empty
        before the first)."""
        return dict(self._stats)

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # don't mask an in-flight exception with a writer error
        try:
            self.wait()
        except BaseException:
            if exc == (None, None, None):
                raise
