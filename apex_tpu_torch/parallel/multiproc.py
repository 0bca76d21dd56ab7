"""Multi-process launcher (counterpart of apex_tpu/parallel/multiproc.py,
itself ≡ apex.parallel.multiproc): start N copies of a training script,
one rank each, wired into one `torch.distributed` world.

Usage:
    python -m apex_tpu_torch.parallel.multiproc --nproc 4 train.py --arg ...

Each child gets, beside the caller's environment:
    APEX_TPU_INIT_METHOD   the rendezvous (`file://...` in a directory the
                           launcher makes and removes, or --init-method)
    APEX_TPU_NUM_PROCESSES the world size
    APEX_TPU_PROCESS_ID    this process's rank
and calls `init_from_env()` first, which joins the process group: gloo
on the CPU, NCCL when the script asks for the card.

Failure semantics: the children are polled together (`wait_fleet`).
The first nonzero exit is the launcher's return code; the surviving
children get `--grace` seconds to finish on their own (0, the default,
ends them at once), then SIGTERM, then SIGKILL.  `--timeout` bounds the
whole fleet (exit 124): a hung run fails instead of hanging.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

__all__ = ["main", "init_from_env", "wait_fleet"]


def init_from_env(device: str = "cpu") -> bool:
    """Child side: join the process group the launcher's variables name
    (≡ `init_process_group(init_method='env://')` in the reference's
    scripts): gloo for `device="cpu"`, NCCL for `device="cuda"`, each
    rank on card `rank % device_count()`.  Returns False, doing nothing,
    when the launcher's variables are absent (a single-process run)."""
    import torch
    import torch.distributed as dist

    init = os.environ.get("APEX_TPU_INIT_METHOD")
    if not init:
        return False
    rank = int(os.environ["APEX_TPU_PROCESS_ID"])
    world = int(os.environ["APEX_TPU_NUM_PROCESSES"])
    if device == "cpu":
        backend, kw = "gloo", {}
    elif device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_from_env(device='cuda'): CUDA is not "
                               "available")
        card = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(card)
        backend, kw = "nccl", {"device_id": card}
    else:
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, **kw)
    return True


def wait_fleet(procs, *, timeout=None, grace=0.0, poll=0.05,
               term_wait=5.0):
    """Poll `procs` (subprocess.Popen) until all exit, any one fails, or
    `timeout` elapses (≡ the JAX package's `wait_fleet`).  Returns the
    fleet's return code: 0 when every child exited 0; the FIRST nonzero
    exit otherwise; 124 on timeout.  After the first failure the
    survivors get `grace` seconds to finish, then are terminated
    (SIGTERM, SIGKILL after `term_wait`); on timeout at once."""
    deadline = None if timeout is None else time.monotonic() + timeout

    def _alive():
        return [p for p in procs if p.poll() is None]

    def _terminate(alive):
        for p in alive:
            try:
                p.terminate()
            except OSError:
                pass
        t_kill = time.monotonic() + term_wait
        for p in alive:
            while p.poll() is None and time.monotonic() < t_kill:
                time.sleep(poll)
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
                p.wait()

    rc = 0
    grace_deadline = None
    while True:
        alive = _alive()
        if rc == 0:
            for p in procs:
                r = p.poll()
                if r:                  # the first failure wins
                    rc = r
                    grace_deadline = time.monotonic() + grace
                    break
        if not alive:
            return rc
        now = time.monotonic()
        if deadline is not None and now >= deadline:
            sys.stderr.write(
                f"multiproc: fleet timeout after {timeout}s — terminating "
                f"{len(alive)} hung child(ren)\n")
            _terminate(alive)
            return rc or 124
        if grace_deadline is not None and now >= grace_deadline:
            _terminate(_alive())
            return rc
        time.sleep(poll)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="apex_tpu_torch multi-process launcher "
                    "(≡ apex/parallel/multiproc.py)")
    parser.add_argument("--nproc", type=int, default=2,
                        help="number of ranks to start")
    parser.add_argument("--init-method", default=None,
                        help="torch.distributed rendezvous (default: a "
                             "file:// store in a fresh temporary "
                             "directory, which needs no port)")
    parser.add_argument("--timeout", type=float, default=None,
                        help="end the whole fleet after this many seconds "
                             "(exit 124)")
    parser.add_argument("--grace", type=float, default=0.0,
                        help="after the first child failure, let the "
                             "others run this many seconds before ending "
                             "them (default 0: at once)")
    parser.add_argument("script", help="training script to run")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    tmp = None
    init = args.init_method
    if init is None:
        tmp = tempfile.mkdtemp(prefix="apex_multiproc_")
        init = "file://" + os.path.join(tmp, "store")
    procs = []
    try:
        for rank in range(args.nproc):
            env = dict(os.environ)
            env["APEX_TPU_INIT_METHOD"] = init
            env["APEX_TPU_NUM_PROCESSES"] = str(args.nproc)
            env["APEX_TPU_PROCESS_ID"] = str(rank)
            cmd = [sys.executable, args.script] + args.script_args
            procs.append(subprocess.Popen(cmd, env=env))
        return wait_fleet(procs, timeout=args.timeout, grace=args.grace)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
