"""One rank of the port's multi-rank CPU tests (tests/test_torch_ddp.py,
tests/test_torch_zero.py, tests/test_torch_fp16.py).

Run by the port's launcher, one process a rank, gloo over a file store:

    python -m apex_tpu_torch.parallel.multiproc --nproc N \
        tests/torch_dist_worker.py CASE_DIR

It imports only torch and the port.  CASE_DIR/inputs.pt holds the
scenario names and their seeded inputs (numpy arrays, made by the test);
each rank runs every scenario in turn and writes its results to
CASE_DIR/out<rank>.pt as numpy arrays, which the test holds against the
JAX package's.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import (DistributedFusedAdam,
                                       DistributedFusedLAMB, FusedAdagrad,
                                       FusedAdam, FusedSGD)
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.parallel import ddp, mesh
from apex_tpu_torch.parallel.clip_grad import clip_grad_norm
from apex_tpu_torch.parallel.larc import LARC
from apex_tpu_torch.parallel.multiproc import init_from_env
from apex_tpu_torch.parallel.sync_batchnorm import sync_batch_norm
from apex_tpu_torch.ops import welford
from apex_tpu_torch.transformer.amp import GradScaler, allreduce_found_inf
from apex_tpu_torch.amp.fp16_optimizer import FP16_Optimizer


def t(a, dtype=None):
    x = torch.from_numpy(np.array(a))
    return x.to(dtype) if dtype is not None else x


def tree_t(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: tree_t(v, dtype) for k, v in tree.items()}
    return t(tree, dtype)


def n(x):
    """A tensor (or tree of them) as fp32 numpy, flattened in leaf order."""
    if isinstance(x, dict):
        leaves = F.tree_leaves(x)
        return np.concatenate([n(leaf).ravel() for leaf in leaves])
    return x.detach().float().numpy()


def local(a, rank, world):
    """Rank `rank`'s slice of a global batch's leading axis."""
    per = a.shape[0] // world
    return a[rank * per:(rank + 1) * per]


def mlp_loss(p, b):
    x, y = b
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return torch.mean((h @ p["w2"] - y).float() ** 2)


def bn_mlp_loss(p, ms, b, group):
    """dense → sync batch norm (its params under "bn") → relu → dense;
    returns (loss, new running stats)."""
    x, y = b
    h = x @ p["w1"]
    h, rm, rv = sync_batch_norm(h, p["bn"]["scale"], p["bn"]["bias"],
                                ms["mean"], ms["var"], training=True,
                                process_group=group)
    h = torch.relu(h)
    loss = torch.mean((h @ p["w2"] - y).float() ** 2)
    return loss, {"mean": rm, "var": rv}


# ---------------------------------- ddp ------------------------------------

def scn_sync(d, rank, world):
    grads = tree_t(d["grads"][rank])
    out = {"sync": n(ddp.sync_gradients(tree_t(d["grads"][rank])))}
    out["bucketed"] = n(ddp.sync_gradients_bucketed(grads, num_buckets=3))
    out["reducer"] = n(ddp.Reducer().reduce(tree_t(d["grads"][rank])))
    wrap = ddp.DistributedDataParallel(lambda p, x: x, bucketed=True,
                                       num_buckets=2)
    out["ddp_sync"] = n(wrap.sync(grads))
    out["sum"] = n(ddp.sync_gradients(tree_t(d["grads"][rank]),
                                      average=False))
    return out


def _make_opt(name):
    if name == "adam":
        return FusedAdam(lr=1e-2, weight_decay=0.01)
    if name == "sgd":
        return FusedSGD(lr=0.1, momentum=0.9)
    if name == "adagrad":
        return FusedAdagrad(lr=1e-2)
    if name == "larc":
        return LARC(FusedSGD(lr=0.1, momentum=0.9), trust_coefficient=0.02,
                    clip=True)
    raise ValueError(name)


def scn_train(d, rank, world):
    """3 steps of make_train_step on this rank's slice of the global
    batch, per optimizer (FusedAdagrad: its own step on synced grads);
    the "sgd_amp" case with O0 and a dynamic loss scale, its second
    step's batch holding an inf on the last rank."""
    out = {}
    for name in d["opts"]:
        amp_state = None
        opt = _make_opt(name.replace("_amp", ""))
        if name.endswith("_amp"):
            amp_state = amp.initialize(opt_level="O0", loss_scale="dynamic",
                                       device="cpu")
        state = opt.init(tree_t(d["params"]))
        if name == "adagrad":
            # FusedAdagrad takes no loss scale: its step runs on grads
            # synced by hand, as the JAX package runs it on synced grads
            def step(state, scaler, batch, opt=opt):
                p = {k: v.detach().requires_grad_(True) for k, v in
                     F.unflatten(state.params, opt.spec).items()}
                loss = mlp_loss(p, batch)
                g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
                _, state = opt.step(state, ddp.sync_gradients(g))
                return state, scaler, loss.detach()
        else:
            step = ddp.make_train_step(mlp_loss, opt, amp_state=amp_state,
                                       device="cpu")
        scaler = amp_state.loss_scalers[0] if amp_state else None
        losses = []
        for i in range(3):
            x = local(d["x"], rank, world).copy()
            if name.endswith("_amp") and i == 1 and rank == world - 1:
                x[0, 0] = np.inf
            state, scaler, loss = step(state, scaler,
                                       (t(x), t(local(d["y"], rank, world))))
            losses.append(float(loss))
        out[name] = n(state.params)
        out[name + "_loss"] = np.asarray(losses)
        if scaler is not None:
            out[name + "_scaler"] = np.asarray(
                [float(scaler.scale), float(scaler.growth_tracker),
                 float(scaler.found_inf), float(state.step)])
    return out


def scn_micro(d, rank, world):
    """num_microbatches=2 with fp32 main grads: fp32 params (FusedSGD)
    and bf16 params (the fp32 master, bf16 step leaves)."""
    out = {}
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        opt = FusedSGD(lr=0.1)
        state = opt.init(tree_t(d["params"], dt))
        step = ddp.make_train_step(mlp_loss, opt, device="cpu",
                                   num_microbatches=2,
                                   main_grad_dtype=torch.float32)
        x = t(local(d["x"], rank, world), dt)
        y = t(local(d["y"], rank, world), dt)
        for _ in range(3):
            state, _, loss = step(state, None, (x, y))
        out[name] = n(state.params)
        out[name + "_loss"] = np.asarray(float(loss))
    return out


def scn_syncbn(d, rank, world):
    group = mesh.data_parallel_group()
    x = t(local(d["x"], rank, world)).requires_grad_(True)
    w = t(local(d["w"], rank, world))
    c = x.shape[-1]
    y, rm, rv = sync_batch_norm(x, torch.ones(c), torch.zeros(c),
                                torch.zeros(c), torch.ones(c),
                                training=True, process_group=group)
    (y * w).sum().backward()
    out = {"y": n(y), "dx": n(x.grad), "rm": n(rm), "rv": n(rv)}
    # uneven counts: rank r holds r % 3 + 1 rows
    rows = t(d["uneven"][rank])
    mean, var, count = welford.batch_stats(rows, (0,))
    tm, tv, tn = welford.merge_stats(mean, var, count, group)
    out.update(u_mean=n(tm), u_var=n(tv), u_count=n(tn))
    return out


def scn_clip(d, rank, world):
    g = ddp.sync_gradients(tree_t(d["grads"][rank]))
    clipped, total = clip_grad_norm(g, 1.0)
    return {"clipped": n(clipped), "norm": n(total)}


# ---------------------------------- ZeRO ------------------------------------

def decay_mask(tree, key=""):
    """No weight decay for the leaves whose key starts with "b" (the
    biases), as the tests' JAX side builds it."""
    if isinstance(tree, dict):
        return {k: decay_mask(v, k) for k, v in tree.items()}
    return not key.startswith("b")


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return n(tree)


def rank_grads(base, rank):
    """Rank r's grads: base · (1 + 0.1 r), the factor rounded to fp32 as
    the JAX side computes it from its fp32 rank."""
    f = float(np.float32(1.0) + np.float32(0.1) * np.float32(rank))
    return {k: {kk: vv * f for kk, vv in v.items()}
            for k, v in tree_t(base).items()}


def _zero_opt(kind, nb, mask, dtype, params, world):
    wd = decay_mask(params) if mask else None
    if kind == "adam":
        return DistributedFusedAdam(world, lr=1e-2, weight_decay=0.01,
                                    n_buckets=nb, master_dtype=dtype,
                                    wd_mask=wd)
    return DistributedFusedLAMB(world, lr=1e-2, weight_decay=0.01,
                                master_dtype=dtype, wd_mask=wd)


def scn_zero(d, rank, world):
    """3 steps of each ZeRO configuration from grads base * (1 + 0.1 r);
    the full params and the gathered state after them."""
    out = {}
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    for name, kind, nb, mask, dt in d["configs"]:
        params = tree_t(d["params"])
        opt = _zero_opt(kind, nb, mask, dtypes[dt], params, world)
        state = opt.init(params)
        grads = rank_grads(d["base"], rank)
        for _ in range(3):
            full, state = opt.step(state, grads)
        sd = opt.gather_state_dict(state)
        out[name] = n(full)
        out[name + "_m"] = n(sd["exp_avg"])
        out[name + "_v"] = n(sd["exp_avg_sq"])
        out[name + "_shard"] = n(state.params_shard)
        out[name + "_layout"] = np.asarray(
            [opt.padded_total, state.params_shard.numel()])
    return out


def scn_zero_step(d, rank, world):
    """make_train_step with DistributedFusedAdam(n_buckets=2, wd_mask)
    and with DistributedFusedLAMB, O0 with a dynamic loss scale, the
    second step's batch holding an inf on the last rank (the overflow
    flag OR-ed over the ranks)."""
    out = {}
    for kind in ("adam", "lamb"):
        params = tree_t(d["params"])
        opt = _zero_opt(kind, 2, True, torch.float32, params, world)
        state = opt.init(params)
        amp_state = amp.initialize(opt_level="O0", loss_scale="dynamic",
                                   device="cpu")
        scaler = amp_state.loss_scalers[0]
        step = ddp.make_train_step(mlp_loss, opt, amp_state=amp_state,
                                   device="cpu")
        for i in range(3):
            x = local(d["x"], rank, world).copy()
            if i == 1 and rank == world - 1:
                x[0, 0] = np.inf
            state, scaler, loss = step(state, scaler,
                                       (t(x), t(local(d["y"], rank, world))))
        out[kind] = n(opt.full_params(state))
        out[kind + "_scaler"] = np.asarray(
            [float(scaler.scale), float(scaler.growth_tracker),
             float(scaler.found_inf), float(state.step)])
    return out


def scn_zero_load(d, rank, world):
    """A gathered state dict written by the JAX package at another shard
    count, loaded here and gathered again; one more step from it."""
    params = tree_t(d["params"])
    opt = DistributedFusedAdam(world, lr=1e-2, weight_decay=0.01,
                               n_buckets=3)
    opt.init(params)
    state = opt.load_gathered_state_dict(d["gathered"])
    sd = opt.gather_state_dict(state)
    out = {"params": n(sd["params"]), "m": n(sd["exp_avg"]),
           "v": n(sd["exp_avg_sq"]), "step": n(sd["step"])}
    _, state = opt.step(state, rank_grads(d["base"], rank))
    sd = opt.gather_state_dict(state)
    out.update(next_params=n(sd["params"]), next_m=n(sd["exp_avg"]),
               next_v=n(sd["exp_avg_sq"]))
    if rank == 0:
        out["gathered"] = {"step": n(sd["step"]),
                           **{k: numpy_tree(sd[k]) for k in
                              ("params", "exp_avg", "exp_avg_sq")}}
    return out


# ---------------------------------- amp -------------------------------------

def scn_found_inf(d, rank, world):
    flag = torch.tensor(rank == world - 1)
    out = {"or": n(allreduce_found_inf(flag))}
    gs = GradScaler(init_scale=8.0, device="cpu")
    g = {"a": torch.full((3,), 8.0 * (rank + 1))}
    if rank == 0:
        g["a"][1] = float("nan")
    grads, found = gs.unscale_and_sync(g)
    gs.update(found)
    out.update(unscaled=n(grads), found=n(found),
               scale=n(gs.state.scale))
    return out


def scn_fp16opt(d, rank, world):
    """FP16_Optimizer(FusedAdam) on grads synced over the ranks, dynamic
    scale from 2^4; the second step's grads overflow on rank 0; the third
    clips by the global norm."""
    opt = FP16_Optimizer(FusedAdam(lr=1e-2), dynamic_loss_scale=True,
                         device="cpu")
    opt.scaler_state = amp.scaler.init("dynamic", init_scale=16.0,
                                       device="cpu")
    state = opt.init(tree_t(d["params"]))
    for i in range(3):
        g = tree_t(d["grads"][rank])
        g = {k: v * opt.scaler_state.scale for k, v in g.items()}
        if i == 1 and rank == 0:
            g["w1"][0, 0] = float("inf")
        g = ddp.sync_gradients(g)
        _, state = opt.step(state, g, max_grad_norm=0.5 if i == 2 else None)
    return {"params": n(state.params), "scale": np.asarray(opt.loss_scale),
            "step": n(state.step)}


def scn_o2(d, rank, world):
    """3 O2 steps of the batch-norm MLP (bf16 params, the "bn" leaves
    fp32, the fp32 master in FusedSGD's buffer) through make_train_step,
    the batch norm synced over the ranks."""
    group = mesh.data_parallel_group()
    params, amp_state = amp.initialize(tree_t(d["params"]), opt_level="O2",
                                       device="cpu")
    opt = FusedSGD(lr=0.1, momentum=0.9)
    state = opt.init(params)
    ms = {"mean": torch.zeros(16), "var": torch.ones(16)}
    seen = []

    def loss_fn(p, mstate, b):
        seen.append(sorted({str(v.dtype) for v in F.tree_leaves(p)}))
        return bn_mlp_loss(p, mstate, b, group)

    step = ddp.make_train_step(loss_fn, opt, amp_state=amp_state,
                               with_state=True, device="cpu")
    scaler = amp_state.loss_scalers[0]
    batch = (t(local(d["x"], rank, world)), t(local(d["y"], rank, world)))
    for _ in range(3):
        state, scaler, ms, loss = step(state, scaler, ms, batch)
    return {"params": n(state.params), "rm": n(ms["mean"]),
            "rv": n(ms["var"]), "scale": n(scaler.scale),
            "bn_dtype": np.asarray(seen[0] == ["torch.bfloat16",
                                               "torch.float32"])}


SCENARIOS = {name[4:]: fn for name, fn in globals().items()
             if name.startswith("scn_")}


def main(case_dir):
    torch.set_num_threads(1)
    if not init_from_env("cpu"):
        raise SystemExit("torch_dist_worker: run it through "
                         "apex_tpu_torch.parallel.multiproc")
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh.initialize_model_parallel()
    inputs = torch.load(os.path.join(case_dir, "inputs.pt"),
                        weights_only=False)
    out = {name: SCENARIOS[name](inputs[name], rank, world)
           for name in inputs["scenarios"]}
    torch.save(out, os.path.join(case_dir, f"out{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])


def run_ranks(case_dir, world, inputs, timeout=240):
    """Write `inputs` to CASE_DIR, run this worker on `world` gloo ranks
    through the port's launcher, and return every rank's results (a list
    by rank).  Raises if the fleet fails."""
    import subprocess

    torch.save(inputs, os.path.join(case_dir, "inputs.pt"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         "--nproc", str(world), "--timeout", str(timeout),
         "--init-method", "file://" + os.path.join(case_dir, "store"),
         os.path.abspath(__file__), case_dir],
        cwd=repo, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{world} ranks exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    return [torch.load(os.path.join(case_dir, f"out{r}.pt"),
                       weights_only=False) for r in range(world)]
