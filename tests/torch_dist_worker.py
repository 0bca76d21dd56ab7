"""One rank of the port's multi-rank CPU tests (tests/test_torch_ddp.py,
tests/test_torch_zero.py, tests/test_torch_fp16.py, the tensor- and
pipeline-parallel files, tests/test_torch_bert_tp.py,
tests/test_torch_checkpoint_sharded.py,
tests/test_torch_checkpoint_tp.py, tests/test_torch_trace.py,
tests/test_torch_comms.py, tests/test_torch_contrib.py and
tests/test_torch_transformer_misc.py).

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
    # the flag is OR-ed over tp and pp (not dp): tensor parallelism over
    # the whole world makes it every rank's
    _tp(world)
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
    _restore()
    return out


def scn_found_inf_mp(d, rank, world):
    """GradScaler.unscale_and_sync + update at each (pp, tp) layout of
    the world with an inf on rank `bad` only: the flag and the scale."""
    out = {}
    for pp, tp, bad in d["layouts"]:
        mesh.destroy_model_parallel()
        mesh.initialize_model_parallel(tensor_model_parallel_size=tp,
                                       pipeline_model_parallel_size=pp)
        gs = GradScaler(init_scale=8.0, device="cpu")
        g = {"a": torch.full((2,), 8.0)}
        if rank == bad:
            g["a"][0] = float("inf")
        _, found = gs.unscale_and_sync(g)
        gs.update(found)
        out[(pp, tp, bad)] = {"found": n(found), "scale": n(gs.state.scale)}
    _restore()
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


# ------------------------------ tensor parallelism --------------------------
#
# The TP scenarios set up the groups they need (tensor parallelism over
# the whole world unless stated) and put the default mesh back after.

def _tp(tp):
    mesh.destroy_model_parallel()
    mesh.initialize_model_parallel(tensor_model_parallel_size=tp)


def _restore():
    mesh.destroy_model_parallel()
    mesh.initialize_model_parallel()


def _raises(exc, fn, *a, **kw):
    try:
        fn(*a, **kw)
    except exc as e:
        return str(e)
    return ""


def scn_tp_mesh(d, rank, world):
    """The groups at every tp size dividing the world: sizes, ranks,
    source ranks, members, sums over each group; the refusals."""
    out = {}
    for tp in d["tps"]:
        _tp(tp)
        tpg = mesh.get_tensor_model_parallel_group()
        dpg = mesh.get_data_parallel_group()
        x = torch.tensor([float(rank + 1)])
        out[tp] = {
            "sizes": np.array([mesh.get_tensor_model_parallel_world_size(),
                               mesh.get_tensor_model_parallel_rank(),
                               mesh.get_data_parallel_world_size(),
                               mesh.get_data_parallel_rank(),
                               mesh.get_tensor_model_parallel_src_rank(),
                               mesh.get_data_parallel_src_rank(),
                               dist.get_world_size(tpg),
                               dist.get_rank(tpg), dist.get_world_size(dpg),
                               dist.get_rank(dpg)]),
            "tp_ranks": np.array(dist.get_process_group_ranks(tpg)),
            "dp_ranks": np.array(dist.get_process_group_ranks(dpg)),
            "tp_sum": n(mesh.all_reduce(x.clone(), "sum", tpg)),
            "dp_sum": n(mesh.all_reduce(x.clone(), "sum", dpg)),
            "world_sum": n(mesh.all_reduce(x.clone(), "sum",
                                           mesh.new_process_group(
                                               ("dp", "tp")))),
            "info": mesh.get_rank_info()}
    mesh.destroy_model_parallel()
    mesh.initialize_model_parallel(use_fp8=True)
    out["amax"] = n(mesh.reduce_amax(torch.tensor([float(rank)])))
    out["axes"] = (mesh.get_amax_reduction_axes(),
                   mesh.get_model_parallel_axes())
    out["refused"] = {
        "tp3": _raises(ValueError, mesh.initialize_model_parallel,
                       tensor_model_parallel_size=3),
        "pp": _raises(ValueError, mesh.initialize_model_parallel,
                      pipeline_model_parallel_size=3),
        "vpp": _raises(ValueError, mesh.initialize_model_parallel,
                       virtual_pipeline_model_parallel_size=2),
        "cp": _raises(TypeError, mesh.initialize_model_parallel,
                      context_parallel_size=2),
        "ep": _raises(ValueError, mesh.initialize_model_parallel,
                      expert_model_parallel_size=3)}
    _restore()
    return out


def _region_fns():
    from apex_tpu_torch.parallel import collectives as C

    return {name: getattr(C, name) for name in (
        "copy_to_tensor_model_parallel_region",
        "reduce_from_tensor_model_parallel_region",
        "scatter_to_tensor_model_parallel_region",
        "gather_from_tensor_model_parallel_region",
        "scatter_to_sequence_parallel_region",
        "gather_from_sequence_parallel_region",
        "gather_from_sequence_parallel_region_no_tp_grad",
        "reduce_scatter_to_sequence_parallel_region")}


def scn_regions(d, rank, world):
    """Each region pair on this rank's x: its output and the gradient of
    sum(y * t) for this rank's t; the ring and halo exchanges; a
    reduce-scatter the group does not divide."""
    from apex_tpu_torch.parallel import collectives as C

    _tp(world)
    out = {}
    for name, fn in _region_fns().items():
        x = t(d[name]["x"][rank]).requires_grad_(True)
        y = fn(x)
        (y * t(d[name]["t"][rank])).sum().backward()
        out[name] = (n(y), n(x.grad))
    r = t(d["ring"][rank])
    out["ring+1"] = n(C.ring_exchange(r, "tp", 1))
    out["ring-1"] = n(C.ring_exchange(r, "tp", -1))
    left, right = C.halo_exchange_1d(t(d["halo"][rank]), "tp", halo=1)
    out["halo"] = n(torch.cat([left, right]))
    out["ragged"] = _raises(
        ValueError, C.reduce_scatter_to_sequence_parallel_region,
        torch.ones(2 * world + 1, 3))
    _restore()
    return out


def _grads_of(loss, leaves):
    return [n(g) for g in torch.autograd.grad(loss, leaves)]


def scn_tp_layers(d, rank, world):
    """The TP layers, cross entropy, LayerNorm and RNG helpers at
    tp = world, on this rank's shards of the global inputs."""
    import torch.nn.functional as Fn

    from apex_tpu_torch.ops import _common
    from apex_tpu_torch.transformer.layers import LayerNorm
    from apex_tpu_torch.transformer.tensor_parallel import random as trandom
    from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
        vocab_parallel_cross_entropy)
    from apex_tpu_torch.transformer.tensor_parallel.layers import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
        shard_tree)

    _tp(world)
    out = {}

    def shards(layer, params):
        return {k: v.requires_grad_(True) for k, v in shard_tree(
            tree_t(params), layer.partition_spec(), rank, world).items()}

    def rows(a):
        return t(local_rows(a, rank, world))

    # column with gather_output
    col = ColumnParallelLinear(12, 24, gather_output=True)
    p = shards(col, d["col"]["params"])
    x = t(d["col"]["x"]).requires_grad_(True)
    y = col.apply(p, x)
    out["col"] = [n(y)] + _grads_of((y ** 2).sum(),
                                    [p["weight"], p["bias"], x])
    # the Megatron MLP: column (no gather) -> gelu -> row
    for name, sp in (("mlp", False), ("sp_mlp", True)):
        c = ColumnParallelLinear(16, 32, sequence_parallel=sp)
        r_ = RowParallelLinear(32, 16, input_is_parallel=True,
                               sequence_parallel=sp)
        pc, pr = shards(c, d[name]["pc"]), shards(r_, d[name]["pr"])
        x = (rows(d[name]["x"]) if sp else t(d[name]["x"])
             ).requires_grad_(True)
        y = r_.apply(pr, Fn.gelu(c.apply(pc, x), approximate="tanh"))
        out[name] = [n(y)] + _grads_of(
            (y ** 2).sum(), [pc["weight"], pc["bias"], pr["weight"],
                             pr["bias"], x])
    # the vocab-parallel embedding, replicated and sequence-parallel out
    for name, sp in (("emb", False), ("sp_emb", True)):
        emb = VocabParallelEmbedding(64, 8, sequence_parallel=sp)
        p = shards(emb, d["emb"]["params"])
        y = emb.apply(p, t(d[name]["ids"]))
        out[name] = [n(y)] + _grads_of((y ** 2).sum(), [p["weight"]])
    # the cross entropy on this rank's vocab shard
    logits, labels = d["xent"]["logits"], t(d["xent"]["labels"])
    for smoothing in (0.0, 0.1):
        for fused in (False, True):
            lg = t(local_cols(logits, rank, world)).requires_grad_(True)
            loss = vocab_parallel_cross_entropy(lg, labels, smoothing,
                                                fused=fused)
            out[f"xent{smoothing}{fused}"] = [n(loss)] + _grads_of(
                loss.mean(), [lg])
    lg = t(local_cols(logits, rank, world), torch.bfloat16
           ).requires_grad_(True)
    loss = vocab_parallel_cross_entropy(lg, labels)
    g, = torch.autograd.grad(loss.mean(), [lg])
    out["xent_bf16"] = [n(loss), n(g), np.asarray(g.dtype == torch.bfloat16)]
    # the sequence-parallel LayerNorm: the weight's and bias's grads
    # summed over the ranks' sequence slices
    ln = LayerNorm(8, sequence_parallel_enabled=True)
    with torch.no_grad():
        ln.weight.copy_(t(d["ln"]["w"]))
        ln.bias.copy_(t(d["ln"]["b"]))
    y = ln(rows(d["ln"]["x"]))
    out["ln"] = [n(y)] + _grads_of((y * rows(d["ln"]["t"])).sum(),
                                   [ln.weight, ln.bias])
    # rank-divergent keys: a draw and a dropout mask of each rank's key
    key = torch.Generator().manual_seed(0)
    mp = trandom.model_parallel_fold_in(key)
    out["draw"] = n(torch.rand(8, generator=mp))
    out["mask"] = n(_common.dropout(trandom.fold_in(mp, 0), 0.5,
                                    torch.ones(256)))
    # the distributed activation storage against the plain remat
    xs, ws = t(d["remat"]["x"]), t(d["remat"]["w"])

    def fn(x_, w_):
        k1, = trandom.split(key, 1)
        return _common.dropout(k1, 0.5, torch.tanh(x_ @ w_)).sum()

    def grads(run):
        xr, wr = xs.clone().requires_grad_(True), ws.clone().requires_grad_(
            True)
        return _grads_of(run(xr, wr), [xr, wr])

    out["remat"] = (grads(lambda a, b: trandom.checkpoint(fn, a, b)),
                    grads(trandom.checkpoint_with_distributed_saved_activations(
                        fn)))
    chunk = trandom.split_tensor_into_1d_equal_chunks(xs)
    out["split"] = (n(chunk), n(trandom.gather_split_1d_tensor(chunk)))
    # a shard on a tp group it does not fit, and a size tp does not divide
    out["bad_shard"] = _raises(ValueError, col.apply,
                               {"weight": torch.zeros(12, 24),
                                "bias": torch.zeros(24)}, torch.zeros(2, 12))
    out["ragged"] = _raises(ValueError, ColumnParallelLinear(
        12, 4 * world + 1).apply, {"weight": torch.zeros(12, 1)},
        torch.zeros(2, 12))
    _restore()
    return out


def local_rows(a, rank, world):
    return local(np.asarray(a), rank, world)


def local_cols(a, rank, world):
    per = a.shape[-1] // world
    return np.asarray(a)[..., rank * per:(rank + 1) * per]


OVERLAP_CASES = ("col_sp", "row_sp", "row_ar", "col_copy")


def overlap_case(case, d, rank, world, chunks, dtype):
    """One TP layer shape of tests/test_overlap.py at `chunks`: its output,
    the local loss sum(y * t) and the grads of weight, bias and input."""
    from apex_tpu_torch.transformer.tensor_parallel.layers import (
        ColumnParallelLinear, RowParallelLinear)

    c = d[case]
    h, o = c["w"].shape
    col = case.startswith("col")
    sp = case.endswith("sp")
    if col:
        lay = ColumnParallelLinear(h, o, sequence_parallel=sp,
                                   overlap_chunks=chunks)
        w, b = local_cols(c["w"], rank, world), local_cols(c["b"], rank,
                                                           world)
        x = local_rows(c["x"], rank, world) if sp else c["x"]
        tt = local_cols(c["t"], rank, world)
    else:
        lay = RowParallelLinear(h, o, sequence_parallel=sp,
                                overlap_chunks=chunks)
        w, b = local_rows(c["w"], rank, world), c["b"]
        x = local_cols(c["x"], rank, world)
        tt = local_rows(c["t"], rank, world) if sp else c["t"]
    w, b, x = (t(a, dtype).requires_grad_(True) for a in (w, b, x))
    y = lay.apply({"weight": w, "bias": b}, x)
    loss = (y.float() * t(tt)).sum()
    return [n(y), n(loss)] + _grads_of(loss, [w, b, x])


def scn_overlap(d, rank, world):
    """The four TP layer shapes at chunks 1, 2 and 4 in fp32 and bf16;
    chunks 3 against 8 local rows (the fallback to 2, one warning)."""
    import warnings

    from apex_tpu_torch.parallel import overlap as OV

    _tp(world)
    out = {}
    for case in OVERLAP_CASES:
        for dname, dtype in (("fp32", torch.float32),
                             ("bf16", torch.bfloat16)):
            for chunks in (1, 2, 4):
                out[(case, dname, chunks)] = overlap_case(
                    case, d, rank, world, chunks, dtype)
    OV._WARNED_SITES.clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out["fallback"] = overlap_case("col_sp", d, rank, world, 3,
                                       torch.float32)
        overlap_case("col_sp", d, rank, world, 3, torch.float32)
    out["warnings"] = [str(r.message) for r in rec
                       if "overlap_chunks" in str(r.message)]
    _restore()
    return out


def _leaf_paths(tree, prefix=()):
    """The key paths of a nested dict's leaves, in insertion order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaf_paths(v, prefix + (k,))
        else:
            out.append(prefix + (k,))
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def scn_gpt(d, rank, world):
    """The small GPT's loss and the gradients of this rank's shards at
    each tp size (with and without sequence parallelism, and chunked),
    then three make_tp_dp_train_step steps at tp = 2 x dp = world / 2."""
    from apex_tpu_torch.models.gpt import GPT, GPTConfig, params_from_jax
    from apex_tpu_torch.transformer import training

    out = {}
    for tp, kw in d["losses"]:
        _tp(tp)
        model = GPT(GPTConfig(**dict(d["cfg"], **kw)))
        params = params_from_jax(d["params"], device="cpu",
                                 tp_rank=mesh.get_tensor_model_parallel_rank(),
                                 tp_size=tp)
        paths = _leaf_paths(params)
        for path in paths:
            _at(params, path).requires_grad_(True)
        loss = model.loss(params, t(d["tokens"]), t(d["labels"]))
        grads = torch.autograd.grad(loss, [_at(params, q) for q in paths])
        case = tuple(sorted(kw.items()))
        out[("loss", tp, case)] = n(loss)
        out[("grads", tp, case)] = {q: n(g) for q, g in zip(paths, grads)}
    if "train" in d:
        tp = d["train"]["tp"]
        _tp(tp)
        model = GPT(GPTConfig(**d["cfg"]))
        opt = FusedAdam(lr=1e-4)
        state = training.init_sharded_optimizer(
            opt, model, params_from_jax(d["params"], device="cpu"))
        step = training.make_tp_dp_train_step(model, opt, device="cpu")
        dpw, dpr = (mesh.get_data_parallel_world_size(),
                    mesh.get_data_parallel_rank())
        losses = []
        for tokens in d["train"]["tokens"]:
            state, loss = step(state, t(local(tokens, dpr, dpw)),
                               t(local(np.roll(tokens, -1, axis=1), dpr,
                                       dpw)))
            losses.append(float(loss))
        out["train"] = {"losses": np.asarray(losses),
                        "params": n(state.params), "step": int(state.step),
                        "tp_rank": mesh.get_tensor_model_parallel_rank()}
    _restore()
    return out


# ---------------------------- pipeline parallelism ---------------------------

def _pp(pp, tp=1, **kw):
    mesh.destroy_model_parallel()
    mesh.initialize_model_parallel(tensor_model_parallel_size=tp,
                                   pipeline_model_parallel_size=pp, **kw)


def scn_pp_mesh(d, rank, world):
    """At each (pp, tp) layout: sizes, coordinates, source ranks, the
    members of every group, a sum over the pp group, the stage helpers
    and the embedding groups (with and without a split), and
    build_model's placement under a virtual pipeline."""
    from apex_tpu_torch.transformer.pipeline_parallel import build_model

    out = {}
    for pp, tp in d["layouts"]:
        _pp(pp, tp)
        groups = {axes: mesh.new_process_group(axes) for axes in
                  (("tp",), ("dp",), ("pp",), ("pp", "tp"), ("dp", "tp"),
                   ("pp", "dp"))}
        x = torch.tensor([float(rank + 1)])
        o = {"sizes": np.array([
            mesh.get_pipeline_model_parallel_world_size(),
            mesh.get_pipeline_model_parallel_rank(),
            mesh.get_data_parallel_world_size(),
            mesh.get_data_parallel_rank(),
            mesh.get_tensor_model_parallel_world_size(),
            mesh.get_tensor_model_parallel_rank(),
            mesh.get_tensor_model_parallel_src_rank(),
            mesh.get_data_parallel_src_rank()]),
            "members": {axes: np.array(dist.get_process_group_ranks(g))
                        for axes, g in groups.items()},
            "pp_ranks": np.array(mesh.get_pipeline_global_device_ranks()),
            "pp_sum": n(mesh.all_reduce(x.clone(), "sum",
                                        mesh.group_of("pp"))),
            "stages": (mesh.is_pipeline_first_stage(),
                       mesh.is_pipeline_last_stage(),
                       mesh.get_pipeline_model_parallel_next_rank(),
                       mesh.get_pipeline_model_parallel_prev_rank(),
                       mesh.get_embedding_group_stages(),
                       mesh.get_position_embedding_group_stages(),
                       mesh.is_rank_in_embedding_group()),
            "info": mesh.get_rank_info()}
        if pp > 1:
            mesh.set_pipeline_model_parallel_split_rank(1)
            o["split"] = (mesh.get_embedding_group_stages(),
                          mesh.get_position_embedding_group_stages(),
                          mesh.get_encoder_relative_position_embedding_group_stages(),
                          mesh.get_decoder_relative_position_embedding_group_stages(),
                          mesh.is_pipeline_stage_before_split(),
                          mesh.is_pipeline_stage_after_split(),
                          mesh.is_pipeline_stage_at_split())
        out[(pp, tp)] = o
    _pp(world, 1, virtual_pipeline_model_parallel_size=2)
    out["vpp"] = {
        "size": mesh.get_virtual_pipeline_model_parallel_world_size(),
        "models": build_model(lambda pre_process, post_process: (
            pre_process, post_process, mesh.get_virtual_pipeline_model_parallel_rank()),
            virtual_pipeline_model_parallel_size=2)}
    _restore()
    return out


def _toy_stage(p, x, c):
    return x + torch.tanh(x @ p["w"] + p["b"])


def scn_pipeline(d, rank, world):
    """spmd_pipeline on the toy stage at each case: its output (the
    stacked outputs, or the mean loss) and the gradients of this stage's
    leaves (and of the microbatches)."""
    from apex_tpu_torch.transformer.pipeline_parallel import spmd_pipeline

    out = {}
    for case in d["cases"]:
        pp, m, chunks, window, remat, mode = case
        _pp(pp)
        s = mesh.get_pipeline_model_parallel_rank()
        w, b = t(d["w"][case]), t(d["b"][case])
        # chunk c of stage s holds global layer c·pp + s
        layers = [c * pp + s for c in range(chunks)]
        p = {"w": w[layers].clone().requires_grad_(),
             "b": b[layers].clone().requires_grad_()}
        mbs = t(d["mbs"][case]).requires_grad_()
        lab = t(d["labels"][case])
        if mode == "loss":
            res = spmd_pipeline(
                _toy_stage, p, mbs, num_model_chunks=chunks,
                remat_stage=remat, checkpoint_window=window,
                loss_fn=lambda y, lbl: torch.sum((y - lbl) ** 2),
                loss_args=lab) / m
            loss = res
        else:
            res = spmd_pipeline(_toy_stage, p, mbs, num_model_chunks=chunks,
                                remat_stage=remat, checkpoint_window=window)
            loss = torch.mean(res ** 2)
        gw, gb, gx = torch.autograd.grad(loss, [p["w"], p["b"], mbs],
                                         allow_unused=True,
                                         materialize_grads=True)
        out[case] = {"out": n(res), "w": n(gw), "b": n(gb), "x": n(gx)}
    _restore()
    return out


def scn_gpt_pp(d, rank, world):
    """GPTPipelined's loss and the gradients of this rank's shard at each
    (pp, tp, m, chunks, sequence_parallel) case, then three
    make_tp_dp_train_step steps at pp 2 x tp 2: the losses, the flat
    parameters and the replicated leaves after them."""
    from apex_tpu_torch.models.gpt import (GPTConfig, GPTPipelined,
                                           params_from_jax)
    from apex_tpu_torch.transformer import training

    def setup(pp, tp, m, chunks, sp):
        _pp(pp, tp)
        model = GPTPipelined(GPTConfig(**d["cfg"], sequence_parallel=sp),
                             m, pp, chunks)
        params = params_from_jax(
            d["params"][(pp, chunks)], device="cpu",
            tp_rank=mesh.get_tensor_model_parallel_rank(), tp_size=tp,
            pp_rank=mesh.get_pipeline_model_parallel_rank(), pp_size=pp)
        return model, params

    out = {}
    for case in d["cases"]:
        model, params = setup(*case)
        paths = _leaf_paths(params)
        for path in paths:
            _at(params, path).requires_grad_(True)
        loss = model.loss(params, t(d["tokens"]), t(d["labels"]))
        grads = torch.autograd.grad(loss, [_at(params, q) for q in paths],
                                    allow_unused=True,
                                    materialize_grads=True)
        out[case] = {"loss": n(loss),
                     "grads": {q: n(g) for q, g in zip(paths, grads)}}
    model, _ = setup(2, 2, 2, 1, False)
    opt = FusedAdam(lr=1e-4)
    state = training.init_sharded_optimizer(
        opt, model, params_from_jax(d["params"][(2, 1)], device="cpu"))
    step = training.make_tp_dp_train_step(model, opt, device="cpu")
    losses = []
    for tokens in d["train_tokens"]:
        state, loss = step(state, t(tokens), t(np.roll(tokens, -1, axis=1)))
        losses.append(float(loss))
    tree = F.unflatten(state.params, opt.spec)
    out["train"] = {"losses": np.asarray(losses), "params": n(state.params),
                    "step": int(state.step),
                    "replicated": {k: n(tree[k]) for k in
                                   ("embed", "pos_embed", "final_ln")}}
    _restore()
    return out


# ---------------------------- context parallelism ----------------------------

def _cp_shard(a, rank, world, axis=2):
    """Rank `rank`'s contiguous shard of a global sequence axis."""
    return np.ascontiguousarray(np.split(np.asarray(a), world,
                                         axis=axis)[rank])


def scn_cp(d, rank, world):
    """Context parallelism over the tp group (tp = world, the axis the
    JAX tests ring over): each ring case's output shard and gradients
    (given do), through `ring_attention`, or through `_ring` / `_ring_zz`
    with the test's int32 seed where there is dropout; rank 0 also runs
    `emulate_ring` over every rank's shards (the virtual-rank drive,
    compared bit for bit); each Ulysses case's output shard and
    gradients; and the long-context example's losses over the world
    group from the JAX example's parameters."""
    from apex_tpu_torch.parallel import context_parallel as cp

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    import torch_long_context_training as ex

    _tp(world)
    group = mesh.get_tensor_model_parallel_group()
    out = {"ring": {}, "emulated": {}, "ulysses": {}}
    for c in d["ring"]:
        q, k, v, do = (t(_cp_shard(c[x], rank, world)).requires_grad_(
            x != "do") for x in ("q", "k", "v", "do"))
        seg = (None if c["seg"] is None
               else t(_cp_shard(c["seg"], rank, world, axis=1)))
        scale = 1.0 / np.sqrt(q.shape[-1])
        if c["rate"]:
            if c["layout"] == "zigzag":
                o = cp._ring_zz(q, k, v, seg, seg, c["seed"], group, scale,
                                dropout_rate=c["rate"])
            else:
                o = cp._ring(q, k, v, seg, seg, c["seed"], group,
                             c["causal"], scale, dropout_rate=c["rate"])
        else:
            o = cp.ring_attention(q, k, v, "tp", causal=c["causal"],
                                  segment_ids=seg, layout=c["layout"])
        grads = torch.autograd.grad(o, (q, k, v), do)
        out["ring"][c["name"]] = [n(x) for x in (o, *grads)]
        if rank == 0:
            shards = [[t(_cp_shard(c[x], r, world)) for r in range(world)]
                      for x in ("q", "k", "v", "do")]
            segs = (None if c["seg"] is None else
                    [t(_cp_shard(c["seg"], r, world, axis=1))
                     for r in range(world)])
            res = cp.emulate_ring(
                *shards, layout=c["layout"], causal=c["causal"],
                q_segs=segs, kv_segs=segs, dropout_rate=c["rate"],
                seed=c["seed"])
            out["emulated"][c["name"]] = [[n(x) for x in lst]
                                          for lst in res]
    for c in d["ulysses"]:
        q, k, v = (t(_cp_shard(c[x], rank, world)).requires_grad_(True)
                   for x in ("q", "k", "v"))
        do = t(_cp_shard(c["do"], rank, world))
        seg = t(_cp_shard(c["seg"], rank, world, axis=1))
        o = cp.ulysses_attention(q, k, v, "tp", causal=c["causal"],
                                 segment_ids=seg, use_flash=c["use_flash"])
        grads = torch.autograd.grad(o, (q, k, v), do)
        out["ulysses"][c["name"]] = [n(x) for x in (o, *grads)]
    e = d["example"]
    a = ex.parse(e["argv"])
    opt = FusedAdam(lr=a.lr)
    state = opt.init(ex.params_from_jax(e["params"]))
    step = ex.make_step(opt, a, dist.group.WORLD)
    shard = [t(_cp_shard(e[x], rank, world, axis=0))
             for x in ("tokens", "labels", "pos")]
    losses = []
    for _ in range(a.steps):
        state, loss = step(state, *shard)
        losses.append(float(loss))
    out["example"] = np.asarray(losses)
    _restore()
    return out


# ---------------------------- expert parallelism ----------------------------

MOE_AXES = (("tp",), ("ep",), ("dp",), ("pp",), ("dp", "ep"), ("ep", "tp"),
            ("dp", "tp"), ("pp", "dp", "ep", "tp"))


def _ep(ep, tp=1):
    mesh.destroy_model_parallel()
    mesh.initialize_model_parallel(tensor_model_parallel_size=tp,
                                   expert_model_parallel_size=ep)


def scn_moe(d, rank, world):
    """Expert parallelism: at each (ep, tp) layout the sizes, coordinates
    and the members of every group; the dispatch/combine round trip
    through the ep all-to-all pair (monolithic and in 2 chunks, an
    elementwise expert); an MoEMLP at ep = 2 (chunks 1 and 2): its output,
    loss and the (dp, ep)-mean of its gradients; two steps of
    `build_moe_train_step` from the JAX weights; the refusals (tp > 1, an
    ep that does not divide the world)."""
    from apex_tpu_torch.models import moe_gpt
    from apex_tpu_torch.moe import dispatch as D
    from apex_tpu_torch.moe import router as R
    from apex_tpu_torch.moe.layer import MoEMLP

    out = {}
    for ep, tp in d["layouts"]:
        _ep(ep, tp)
        out[("mesh", ep, tp)] = {
            "sizes": np.array([
                mesh.get_data_parallel_world_size(),
                mesh.get_data_parallel_rank(),
                mesh.get_expert_model_parallel_world_size(),
                mesh.get_expert_model_parallel_rank(),
                mesh.get_tensor_model_parallel_world_size(),
                mesh.get_tensor_model_parallel_rank()]),
            "axes": mesh.get_data_parallel_axis_names(),
            "info": mesh.get_rank_info(),
            "groups": {axes: dist.get_process_group_ranks(
                mesh.new_process_group(axes)) for axes in MOE_AXES},
            "data_group": dist.get_process_group_ranks(
                mesh.data_parallel_group())}
    _ep(2)
    e = d["n_experts"]
    xl = local(t(d["x"]), rank, world)
    tl = xl.shape[0]
    idx = (torch.arange(tl)[:, None] * 3) % e
    cap = R.expert_capacity(tl, e, 1, float("inf"))
    dest, _ = R.capacity_destinations(idx, e, cap)
    buf = D.dispatch(xl, dest, e, cap)
    ones = torch.ones((tl, 1))
    ybuf = D.exchange_combine(D.exchange_dispatch(buf, "ep", 2, e, cap),
                              "ep", 2, e, cap)
    out["roundtrip"] = n(D.combine(ybuf, dest, ones))
    ybuf = D.chunked_expert_exchange(buf, lambda xe: xe * 2.0 + 1.0, "ep",
                                     2, e, cap, chunks=2)
    out["roundtrip_chunks"] = n(D.combine(ybuf, dest, ones))
    m = d["mlp"]
    for chunks in (1, 2):
        layer = MoEMLP(m["hidden"], m["ffn"], e, top_k=2,
                       capacity_factor=2.0, ep_size=2,
                       overlap_chunks=chunks)
        params = tree_t(m["params"])
        names = sorted(params)
        for k in names:
            params[k].requires_grad_(True)
        y, _ = layer.apply(params, local(t(m["x"]), rank, world))
        loss = torch.sum(y * local(t(m["t"]), rank, world))
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        ddp.sync_gradients(list(grads))            # the (dp, ep) mean
        out[("mlp", chunks)] = {"y": n(y), "loss": n(loss),
                                "grads": {k: n(g) for k, g in
                                          zip(names, grads)}}
    model, step, _, info = moe_gpt.build_moe_train_step("cpu")
    opt = info["optimizer"]
    state = opt.init(moe_gpt.params_from_jax(d["gpt_params"], device="cpu"))
    r = mesh.group_rank(mesh.data_parallel_group())
    tokens = t(local(d["tokens"], r, world))
    labels = t(local(np.roll(d["tokens"], -1, axis=1), r, world))
    losses, stats = [], []
    for _ in range(2):
        state, _, loss, st = step(state, None, (tokens, labels))
        losses.append(float(loss))
        stats.append({k: float(v) for k, v in st.items()})
    out["train"] = {"losses": np.asarray(losses), "stats": stats,
                    "shard": n(state.params_shard),
                    "layout": opt.shard_layout(),
                    "ep": info["ep"], "dp": info["dp"],
                    "local_batch": info["local_batch"]}
    _ep(1, 2)
    layer = MoEMLP(m["hidden"], m["ffn"], e, top_k=2, tp_axis="tp")
    out["tp_refused"] = _raises(NotImplementedError, layer.apply,
                                tree_t(m["params"]), t(m["x"]))
    out["ep3_refused"] = _raises(ValueError, mesh.initialize_model_parallel,
                                 expert_model_parallel_size=3)
    _restore()
    return out


# ------------------------------- BERT at tp > 1 -------------------------------

def scn_bert_tp(d, rank, world):
    """The small BERT's MLM + NSP loss at tp = 2 (dense and flash
    attention, each rank on its shard of the JAX weights), then three
    FusedLAMB steps of make_tp_dp_train_step at tp = 2: "tp2" gives both
    dp ranks the whole batch (so the step is the tp = 2 x dp = 1 step),
    "tp2dp2" splits it over dp."""
    from apex_tpu_torch.models.bert import Bert, BertConfig, params_from_jax
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.transformer import training
    from apex_tpu_torch.transformer.pipeline_parallel import (
        get_params_for_weight_decay_optimization)

    _tp(2)
    tpr = mesh.get_tensor_model_parallel_rank()
    dpw, dpr = (mesh.get_data_parallel_world_size(),
                mesh.get_data_parallel_rank())
    out = {"tp_rank": tpr}
    b = d["batch"]
    for flash in (False, True):
        model = Bert(BertConfig(**d["cfg"], use_flash_attention=flash))
        params = params_from_jax(d["params"], device="cpu", tp_rank=tpr,
                                 tp_size=2)
        out[("loss", flash)] = n(model.loss(
            params, t(b["tokens"]), t(b["mlm"]), t(b["mask"]),
            nsp_labels=t(b["nsp"]), tokentype_ids=t(b["tt"]),
            pad_mask=t(b["pad"])))
    model = Bert(BertConfig(**d["cfg"]))

    def loss_fn(p, tokens, lab):
        return model.loss(p, tokens, lab[0], lab[1], lab[2],
                          tokentype_ids=lab[3], pad_mask=lab[4])

    for name, split in (("tp2", False), ("tp2dp2", True)):
        gparams = tree_t(d["params"])
        opt = FusedLAMB(lr=1e-4, weight_decay=0.01,
                        wd_mask=get_params_for_weight_decay_optimization(
                            gparams))
        state = training.init_sharded_optimizer(opt, model, gparams)
        step = training.make_tp_dp_train_step(model, opt, device="cpu",
                                              loss_fn=loss_fn)
        losses = []
        for bb in d["steps"]:
            cut = ((lambda a: local(a, dpr, dpw)) if split
                   else (lambda a: a))
            state, loss = step(state, t(cut(bb["tokens"])), tuple(
                t(cut(bb[k])) for k in ("mlm", "mask", "nsp", "tt", "pad")))
            losses.append(float(loss))
        out[name] = {"losses": np.asarray(losses), "params": n(state.params),
                     "step": int(state.step)}
    _restore()
    return out


# ------------------------------- checkpoints ---------------------------------

def scn_ckpt(d, rank, world):
    """ZeRO-2 checkpoints at dp = world: restore the JAX package's dp = 4
    save, save the restored state again (same step), take one step and
    save that.  Returns this rank's shards after the restore and after
    the step."""
    from apex_tpu_torch.checkpoint import CheckpointManager

    def shards(state):
        return {f: n(getattr(state, f)).copy() for f in state._fields}

    params = tree_t(d["params"])
    opt = DistributedFusedAdam(world, lr=1e-3, n_buckets=2)
    opt.init(params)
    state, _, manifest = CheckpointManager(d["jax_dir"], opt).restore(
        device="cpu")
    out = {"restored": shards(state), "layout": opt.shard_layout(),
           "restored_step": manifest["step"]}
    for directory, step in ((d["same_dir"], manifest["step"]),
                            (d["next_dir"], manifest["step"] + 1)):
        if directory == d["next_dir"]:
            _, state = opt.step(state, tree_t(d["grads"]))
            out["stepped"] = shards(state)
        with CheckpointManager(directory, opt, every_n_steps=1) as mgr:
            assert mgr.multihost == (world > 1)
            mgr.save(step, state)
        # rank 0's writer commits behind the file barrier
        dist.barrier()
    return out


def seeded_moments(n, seed):
    """The global (m, v) of a checkpoint case: seeded numpy (the JAX side
    of tests/test_torch_checkpoint_tp.py draws the same)."""
    rng = np.random.RandomState(seed)
    return ((rng.randn(n) * 1e-3).astype(np.float32),
            (rng.rand(n) * 1e-6).astype(np.float32))


def scn_ckpt_tp(d, rank, world):
    """Checkpoints of states cut over tp or pp, one mesh a case
    (d["cases"]): the rank's row of the global state (its own sharded
    init's params at step 1, the rows of the seeded moments), saved at
    JAX_STEP; one make_tp_dp_train_step step, saved; a fresh optimizer
    restores that save, and the run and the resumed run each take one
    more step."""
    from apex_tpu_torch.checkpoint import CheckpointManager
    from apex_tpu_torch.models.gpt import (GPT, GPTConfig, GPTPipelined,
                                           params_from_jax)
    from apex_tpu_torch.transformer import training

    def rows(state):
        return {f: n(getattr(state, f)).copy() for f in state._fields}

    out = {}
    for case in d["cases"]:
        tp, pp = case["tp"], case["pp"]
        _pp(pp, tp)
        cfg = GPTConfig(**d["cfg"])
        model = GPTPipelined(cfg, 2, pp) if pp > 1 else GPT(cfg)

        def fresh():
            opt = FusedAdam(lr=1e-3)
            state = training.init_sharded_optimizer(
                opt, model, params_from_jax(case["params"], device="cpu"))
            return opt, state

        opt, state = fresh()
        row = (mesh.get_pipeline_model_parallel_rank() * tp
               + mesh.get_tensor_model_parallel_rank())
        per = state.params.numel()
        m, v = (a[row * per:(row + 1) * per]
                for a in seeded_moments(tp * pp * per, case["seed"]))
        state.step.fill_(1)
        state.exp_avg.copy_(t(m))
        state.exp_avg_sq.copy_(t(v))
        res = {"row": row, "saved": rows(state)}
        with CheckpointManager(case["same_dir"], opt,
                               every_n_steps=1) as mgr:
            res["multihost"] = mgr.multihost
            mgr.save(d["step"], state)
        dist.barrier()       # rank 0 commits behind the file barrier
        step = training.make_tp_dp_train_step(model, opt, device="cpu")
        dpw, dpr = (mesh.get_data_parallel_world_size(),
                    mesh.get_data_parallel_rank())

        def batch(tokens):
            return (t(local(tokens, dpr, dpw)),
                    t(local(np.roll(tokens, -1, axis=1), dpr, dpw)))

        state, _ = step(state, *batch(d["tokens"][0]))
        with CheckpointManager(case["next_dir"], opt) as mgr:
            mgr.save(d["step"] + 1, state)
        dist.barrier()
        res["stepped"] = rows(state)
        opt2, _ = fresh()
        back, _, m2 = CheckpointManager(case["next_dir"],
                                        opt2).restore(device="cpu")
        res["resumed_step"] = m2["step"]
        res["resumed_bit_for_bit"] = all(
            torch.equal(getattr(back, f), getattr(state, f))
            for f in state._fields)
        step2 = training.make_tp_dp_train_step(model, opt2, device="cpu")
        _, res["next_loss"] = step(state, *batch(d["tokens"][1]))
        _, res["resumed_next_loss"] = step2(back, *batch(d["tokens"][1]))
        res["next_loss"] = n(res["next_loss"])
        res["resumed_next_loss"] = n(res["resumed_next_loss"])
        out[case["name"]] = res
    _restore()
    return out


# ------------------------------ monitor --------------------------------------

def scn_trace_timing(d, rank, world):
    """The monitor's planes across ranks: make_train_step with metrics
    and the rank-timing plane (TraceConfig(taps=False, rank_timing=True))
    over FusedAdam and over DistributedFusedAdam (the ZeRO-2 squared
    sums and loss in one all-reduce), three steps on this rank's slice of
    the batch and its row of each step's timing matrix (a tensor, or a
    host list on step 1); then forward_backward_no_pipelining with a
    host list as rank_timing= and metrics=."""
    from apex_tpu_torch import monitor
    from apex_tpu_torch.monitor.trace import TraceConfig
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        forward_backward_no_pipelining)

    out = {}
    cfg = TraceConfig(taps=False, rank_timing=True)
    for kind in ("dense", "zero"):
        params = tree_t(d["params"])
        opt = (FusedAdam(lr=1e-2, weight_decay=0.01) if kind == "dense" else
               DistributedFusedAdam(world, lr=1e-2, weight_decay=0.01,
                                    n_buckets=2))
        state = opt.init(params)
        step = ddp.make_train_step(mlp_loss, opt, device="cpu", metrics=True,
                                   trace=cfg)
        m = monitor.init_metrics("cpu")
        for i in range(3):
            b = (t(local(d["x"], rank, world)), t(local(d["y"], rank, world)))
            # a host list on step 1: the step moves it to its device
            row = d["timing"][i][rank]
            state, _, _, m, gathered = step(
                state, None, b, m, row.tolist() if i == 1 else t(row))
            out[f"{kind}_gathered{i}"] = n(gathered)
            out[f"{kind}_metrics{i}"] = np.asarray([float(v) for v in m])
    w = tree_t(d["fb_w"])
    loss, grads, m, gathered = forward_backward_no_pipelining(
        lambda p, mb: torch.mean((mb @ p["w"]) ** 2),
        t(d["fb_batch"]), w, num_microbatches=2,
        metrics=monitor.init_metrics("cpu"),
        rank_timing=d["fb_timing"][rank].tolist())
    out["fb_gathered"] = n(gathered)
    out["fb_metrics"] = np.asarray([float(v) for v in m])
    return out


def scn_comms(d, rank, world):
    """The comms observatory at tp = world: `monitor.comms_report` of the
    Megatron MLP (column without gather -> gelu -> row), with and without
    sequence parallelism, as the JAX test harness runs it (its output,
    then the gradient of the sum of squares of a second forward); each
    collective's (kind, dtype, operand bytes, output bytes, group size,
    axes), the report's dict and table; then the same function under a
    CPU `ProfileCapture` (a gloo trace) and `crosscheck_comms` of the
    two."""
    import tempfile

    import torch.nn.functional as Fn

    from apex_tpu_torch import monitor
    from apex_tpu_torch.transformer.tensor_parallel.layers import (
        ColumnParallelLinear, RowParallelLinear, shard_tree)

    _tp(world)
    out = {}
    for name, sp in (("mlp", False), ("sp_mlp", True)):
        c = ColumnParallelLinear(16, 32, sequence_parallel=sp)
        r_ = RowParallelLinear(32, 16, input_is_parallel=True,
                               sequence_parallel=sp)
        pc = shard_tree(tree_t(d["pc"]), c.partition_spec(), rank, world)
        pr = shard_tree(tree_t(d["pr"]), r_.partition_spec(), rank, world)
        x = t(local_rows(d["x"], rank, world)) if sp else t(d["x"])

        def fwd(pc, pr, x):
            return r_.apply(pr, Fn.gelu(c.apply(pc, x), approximate="tanh"))

        def step(pc, pr, x):
            y = fwd(pc, pr, x)
            leaves = [v.detach().requires_grad_(True)
                      for v in (pc["weight"], pc["bias"], pr["weight"],
                                pr["bias"], x)]
            p1 = {"weight": leaves[0], "bias": leaves[1]}
            p2 = {"weight": leaves[2], "bias": leaves[3]}
            loss = (fwd(p1, p2, leaves[4]) ** 2).sum()
            return y.detach(), torch.autograd.grad(loss, leaves)

        rep = monitor.comms_report(step, (pc, pr, x))
        out[name] = {
            "collectives": [(k.kind, k.dtype, k.operand_bytes,
                             k.output_bytes, k.group_size, k.axes)
                            for k in rep.collectives],
            "report": rep.to_dict(),
            "table": monitor.render_comms_table(rep, label=name)}
        with tempfile.TemporaryDirectory() as logdir:
            cap = monitor.profile_capture(range(1), logdir=logdir,
                                          device="cpu")
            with cap.step(0):
                step(pc, pr, x)
            tl = monitor.analyze_trace(cap.trace_path())
        out[name]["timeline"] = tl.to_dict()
        out[name]["crosscheck"] = monitor.crosscheck_comms(tl, rep)
    _restore()
    return out


def scn_contrib(d, rank, world):
    """The contrib collectives: spatial_conv2d over this rank's band of
    H rows (its output, the input's gradient and the weight's, summed
    over the ranks), PeerHaloExchanger1d over a 32-row ramp, and
    BatchNorm2d_NHWC over two groups of world / 2 ranks (fuse_relu with
    the add-ReLU of z)."""
    from apex_tpu_torch.contrib.bottleneck import spatial_conv2d
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.contrib.peer_memory import PeerHaloExchanger1d

    rows = d["x"].shape[1] // world
    band = slice(rank * rows, (rank + 1) * rows)
    x = t(d["x"][:, band]).requires_grad_(True)
    w = t(d["w"]).permute(3, 0, 1, 2).contiguous().requires_grad_(True)
    y = spatial_conv2d(x, w, "dp")
    (y * t(d["gy"][:, band])).sum().backward()
    gw = w.grad.clone()
    dist.all_reduce(gw)
    out = {"y": n(y), "gx": n(x.grad), "gw": n(gw)}
    ramp = torch.arange(32.0).reshape(1, 32, 1, 1)[:, 8 * rank:8 * rank + 8]
    left, right = PeerHaloExchanger1d(half_halo=1, axis_name="dp")(ramp)
    out.update(left=n(left), right=n(right))
    half = world // 2
    groups = [dist.new_group(list(range(g * half, (g + 1) * half)))
              for g in range(2)]
    mine = groups[rank // half]
    per = d["bn_x"].shape[0] // world
    sl = slice(rank * per, (rank + 1) * per)
    bn = BatchNorm2d_NHWC(6, fuse_relu=True, bn_group=half,
                          process_group=mine, device="cpu")
    params, state = bn.init(device="cpu")
    yb, st = bn.apply(params, state, t(d["bn_x"][sl]), training=True,
                      z=t(d["bn_z"][sl]))
    out.update(bn=n(yb), bn_rm=n(st["running_mean"]),
               bn_rv=n(st["running_var"]))
    return out


def scn_broadcast(d, rank, world):
    """`broadcast_data` of this rank's own batch (rank r's entries are
    d["batch"] + r): every rank ends with rank 0's; the collectives it
    issued, as the comms inventory recorded them (an all-reduce a key);
    a deprecation warning from each rank (rank 0's only is emitted)."""
    import warnings

    import apex_tpu_torch
    from apex_tpu_torch.monitor.comms.inventory import InventoryRecorder
    from apex_tpu_torch.monitor.comms.inventory import recording
    from apex_tpu_torch.transformer.tensor_parallel import broadcast_data

    mine = {k: torch.from_numpy(v + rank) for k, v in d["batch"].items()}
    rec = InventoryRecorder()
    with recording(rec):
        got = broadcast_data(list(d["batch"]), mine, torch.int32,
                             device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        apex_tpu_torch.deprecated_warning("old name")
    return {"got": {k: n(v) for k, v in got.items()},
            "kinds": [e["kind"] for e in rec.entries],
            "group_sizes": [e["group_size"] for e in rec.entries],
            "warned": len(caught)}


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
