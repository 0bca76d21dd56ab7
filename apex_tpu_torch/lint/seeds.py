"""Seeded programs, one a rule: each breaks exactly one of the linter's
rules, so that the rule must fire on it (`python -m apex_tpu_torch.lint
--seeds`, the card's phase of `chip_smoke.py` and the CPU tests run
them).  They are the port's spellings of the JAX package's seeded cases
(tests/test_lint.py there).

`SEEDS` maps a rule id to `fn(device) -> findings`.  The collective
seeds need a process group: `one_rank_world(device)` makes a one-rank
world (gloo on the CPU, NCCL on the card) with the default mesh when
none is up, and takes down only what it made.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch
import torch.distributed as dist

from apex_tpu_torch.lint import engine as E
from apex_tpu_torch.lint import hostsync
from apex_tpu_torch.lint.findings import Finding
from apex_tpu_torch.ops._common import loop_iteration, resolve_device
from apex_tpu_torch.parallel import mesh as M


@contextlib.contextmanager
def one_rank_world(device):
    """A one-rank torch.distributed world and the default mesh over it,
    unless a world is up already."""
    dev = resolve_device(device)
    made = not dist.is_initialized()
    if made:
        kw = {}
        if dev.type == "cuda":
            kw["device_id"] = dev
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    mesh_made = not M.model_parallel_is_initialized()
    if mesh_made:
        M.initialize_model_parallel()
    try:
        yield
    finally:
        if mesh_made:
            M.destroy_model_parallel()
        if made:
            dist.destroy_process_group()


def _t(dev, *shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).to(dev)


# ------------------------------ dtype policy ------------------------------

def dp101(dev):
    """One fp32 GEMM among bf16 ones."""
    def f(x32, xbf, w):
        a = xbf @ w                       # the policy-conformant GEMM
        b = x32 @ x32.T                   # the fp32 offender
        return a.float().sum() + b.sum()

    return E.lint_program(f, (_t(dev, 64, 64),
                              _t(dev, 64, 64, dtype=torch.bfloat16),
                              _t(dev, 64, 64, dtype=torch.bfloat16)),
                          program="seed")


def dp102(dev):
    """fp32 -> bf16 -> fp32 with nothing between."""
    return E.lint_program(lambda x: x.bfloat16().float() + 1.0,
                          (_t(dev, 128, 128),), program="seed")


def dp103(dev):
    """A bf16 sum of 2^18 bf16 elements."""
    return E.lint_program(lambda x: x.sum(),
                          (_t(dev, 1 << 18, dtype=torch.bfloat16),),
                          program="seed")


def dp104(dev):
    """The update computed in bf16 and stored into the fp32 master."""
    def f(p, g):
        p.copy_(p.bfloat16() - 0.1 * g)
        return p

    return E.lint_program(f, (_t(dev, 1 << 15),
                              _t(dev, 1 << 15, dtype=torch.bfloat16)),
                          program="seed")


def dp105(dev):
    """A bf16 router softmax feeding top-k."""
    def f(x, wg):
        probs = torch.softmax(x @ wg, dim=-1)
        g, _ = torch.topk(probs, 2)
        return g.sum()

    return E.lint_program(f, (_t(dev, 64, 32, dtype=torch.bfloat16),
                              _t(dev, 32, 8, dtype=torch.bfloat16)),
                          program="seed")


# ------------------------------ collectives ------------------------------

def cl201(dev):
    """An all-reduce over a group that is none of the mesh's."""
    with one_rank_world(dev):
        other = dist.new_group([0])
        return E.lint_program(
            lambda x: M.all_reduce(x.clone(), "sum", other),
            (_t(dev, 8),), program="seed",
            config=E.LintConfig(expected_axes=M.mesh_axes()[0]))


def cl202(dev):
    """An all-reduce of an all-reduced value, and of an averaged one."""
    with one_rank_world(dev):
        g = M.group_of(M.DP_AXIS)

        def f(x):
            a = M.all_reduce(M.all_reduce(x.clone(), "sum", g), "sum", g)
            b = M.all_reduce(x.clone(), "sum", g)
            b.div_(M.group_size(g))
            return a + M.all_reduce(b, "sum", g)

        return E.lint_program(f, (_t(dev, 8),), program="seed")


def cl203(dev):
    """An all-reduce of a value the loop never changes."""
    with one_rank_world(dev):
        g = M.group_of(M.DP_AXIS)

        def f(w, xs):
            c = torch.zeros((), device=w.device)
            for i in range(xs.shape[0]):
                with loop_iteration("body", i):
                    r = M.all_reduce(w.clone(), "sum", g)
                    c = c + r.sum() + xs[i].sum()
            return c

        return E.lint_program(f, (_t(dev, 8), _t(dev, 4, 8)),
                              program="seed")


def cl204(dev):
    """An fp16 all-reduce sum."""
    with one_rank_world(dev):
        g = M.group_of(M.DP_AXIS)
        return E.lint_program(lambda x: M.all_reduce(x.clone(), "sum", g),
                              (_t(dev, 8, dtype=torch.float16),),
                              program="seed")


def cl205(dev):
    """An all-reduce whose result nothing reads."""
    with one_rank_world(dev):
        g = M.group_of(M.DP_AXIS)

        def f(x):
            M.all_reduce(x.clone(), "sum", g)
            return x * 2.0

        return E.lint_program(f, (_t(dev, 8),), program="seed")


def cl206(dev):
    """An all-to-all over a group that is none of the mesh's."""
    with one_rank_world(dev):
        other = dist.new_group([0])

        def f(x):
            out = torch.empty_like(x)
            M.all_to_all(out, x.clone(), other)
            return out

        return E.lint_program(f, (_t(dev, 8, 8),), program="seed")


def cl207(dev):
    """An exchange that sends to a rank the group does not have (the
    linter holds it back instead of hanging)."""
    with one_rank_world(dev):
        g = M.group_of(M.DP_AXIS)
        n = M.group_size(g)

        def f(x):
            buf = torch.empty_like(x)
            for w in M.exchange([(x.clone(), n, buf, 0)], g):
                w.wait()
            return buf

        return E.lint_program(f, (_t(dev, 8),), program="seed")


# ------------------------------ donation ------------------------------

def _small_step(dev):
    """A ddp.make_train_step over a (128, 128) linear model with
    FusedAdam: a state of 3 x 64 KiB."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import ddp

    opt = FusedAdam(lr=1e-3)
    state = opt.init({"w": _t(dev, 128, 128)})

    def loss_fn(p, b):
        return ((b[0] @ p["w"] - b[1]) ** 2).mean()

    step = ddp.make_train_step(loss_fn, opt, device=dev)
    return step, (state, None, (_t(dev, 4, 128), _t(dev, 4, 128)))


def dn301(dev):
    """The state argument left out of donate_argnums."""
    step, args = _small_step(dev)
    return E.lint_step(step, args, program="seed", donate_argnums=())


def dn302(dev):
    """A compile report whose donation check failed."""
    step, args = _small_step(dev)
    return E.lint_step(step, args, program="seed",
                       compile_report={"donation_ok": False,
                                       "undonated_bytes": 123456,
                                       "donated_bytes": 654321})


# ------------------------------ host syncs ------------------------------

SEEDED_SOURCE = '''
import numpy as np
import torch
from apex_tpu_torch.ops._common import device_step

@device_step
def step(x, y):
    if x.sum() > 0:              # HS404
        z = float(y)             # HS402
    v = x.item()                 # HS401
    a = y.cpu()                  # HS403
    if x.shape[0] > 2:           # a host value: exempt
        pass
    if y is None:                # an identity test: exempt
        pass
    return x

def make(n):
    lr = 0.0

    @torch.compile
    def update(p):
        return p - lr * p        # HS406: lr rebound in the loop below

    out = None
    for i in range(n):
        lr = 0.1 * i
        f = torch.compile(lambda q: q)   # HS405
        out = update(out)
    return out

def warmup(step_fn, state, batch):
    for _ in range(3):
        state, loss = step_fn(state, batch)
    print(loss.item())           # the host side: fine
    return state
'''


def _source(rule):
    def fn(dev):
        return [f for f in hostsync.lint_source_text(SEEDED_SOURCE,
                                                     "seeded.py")
                if f.rule == rule]
    fn.__doc__ = f"The seeded source's {rule} line."
    return fn


SEEDS: Dict[str, Callable[[torch.device], List[Finding]]] = {
    "DP101": dp101, "DP102": dp102, "DP103": dp103, "DP104": dp104,
    "DP105": dp105,
    "CL201": cl201, "CL202": cl202, "CL203": cl203, "CL204": cl204,
    "CL205": cl205, "CL206": cl206, "CL207": cl207,
    "DN301": dn301, "DN302": dn302,
    **{r: _source(r) for r in ("HS401", "HS402", "HS403", "HS404",
                               "HS405", "HS406")},
}


def fire(rule: str, device=None) -> List[Finding]:
    """The findings of `rule`'s seeded program with that rule's id."""
    dev = resolve_device(device)
    return [f for f in SEEDS[rule](dev) if f.rule == rule]
