"""The port's tensor-parallel layers, vocab-parallel cross entropy,
sequence-parallel LayerNorm and tp RNG / activation-storage helpers
(apex_tpu_torch.transformer.tensor_parallel, .layers) at tp = 2 and 4
against the JAX package's, on the CPU.

The port runs as 2 and 4 gloo ranks started by its launcher (one
module-scoped world each, tests/torch_dist_worker.py), each rank on its
shard of the same seeded numpy parameters; the JAX package runs them
inside `shard_map` on a tp = 2 or 4 mesh of its CPU devices, gradients
taken inside the region as tests/test_tensor_parallel_layers.py takes
them.  Tolerances: fp32 1e-5 (relative and absolute: the ranks' partial
sums added in another order); the bf16 cross entropy's gradient, which
both packages round to bf16 once from the same fp32 value, 2e-2 / 2e-3
as the JAX package's own bf16 test."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.models.gpt import GPT as JaxGPT
from apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from apex_tpu.parallel import mesh as JM
from apex_tpu.transformer.layers import LayerNorm as JLayerNorm
from apex_tpu.transformer.tensor_parallel import (
    ColumnParallelLinear as JCol,
    RowParallelLinear as JRow,
    VocabParallelEmbedding as JEmb,
    vocab_parallel_cross_entropy as jxent,
)
from apex_tpu_torch.models.gpt import GPT, GPTConfig
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

WORLDS = (2, 4)
COL_SPEC = {"weight": P(None, "tp"), "bias": P("tp")}
ROW_SPEC = {"weight": P("tp", None), "bias": P()}
E_SPEC = {"weight": P("tp", None)}
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(world):
    rng = np.random.default_rng(21)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def lin(i, o):
        return {"weight": normal(i, o, scale=i ** -0.5),
                "bias": normal(o, scale=0.1)}

    mlp = {"pc": lin(16, 32), "pr": lin(32, 16)}
    return {"scenarios": ["tp_layers"], "tp_layers": {
        "col": {"params": lin(12, 24), "x": normal(5, 12)},
        "mlp": dict(mlp, x=normal(7, 16)),
        "sp_mlp": dict(mlp, x=normal(4 * world, 16)),
        "emb": {"params": {"weight": normal(64, 8)},
                "ids": rng.integers(0, 64, (4, 6)).astype(np.int64)},
        "sp_emb": {"ids": rng.integers(0, 64, (2 * world, 3)
                                       ).astype(np.int64)},
        "xent": {"logits": normal(6, 64, scale=3.0),
                 "labels": rng.integers(0, 64, (6,)).astype(np.int64)},
        "ln": {"w": normal(8, scale=0.5) + 1, "b": normal(8, scale=0.1),
               "x": normal(2 * world, 8), "t": normal(2 * world, 8)},
        "remat": {"x": normal(2 * world, 6), "w": normal(6, 6)}}}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"tp{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    d = tmp_path_factory.mktemp(f"tp{world}")
    inputs = _inputs(world)
    return world, inputs["tp_layers"], W.run_ranks(str(d), world, inputs)


def _mesh(world):
    JM.destroy_model_parallel()
    return JM.initialize_model_parallel(tensor_model_parallel_size=world,
                                        devices=jax.devices()[:world])


def _smap(fn, mesh, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))


def _fwd_grad(fn, loss, mesh, in_specs, y_spec, g_specs, argnums):
    """fn's output and the gradient of loss(fn(...)) in one shard_map,
    both taken inside the region as the training steps take them."""
    def local(*a):
        return fn(*a), jax.grad(lambda *b: loss(fn(*b), *b),
                                argnums=argnums)(*a)
    return _smap(local, mesh, in_specs, (y_spec, g_specs))


def _cols(a, r, world):
    a = np.asarray(a)
    per = a.shape[-1] // world
    return a[..., r * per:(r + 1) * per]


def _rows(a, r, world):
    a = np.asarray(a)
    per = a.shape[0] // world
    return a[r * per:(r + 1) * per]


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               err_msg=what, **tol)


def test_column_parallel_linear_gather_output(ranks):
    world, d, outs = ranks
    mesh = _mesh(world)
    col = JCol(12, 24, gather_output=True)
    p, x = d["col"]["params"], d["col"]["x"]
    y, g = _fwd_grad(col.apply, lambda y_, *a: jnp.sum(y_ ** 2), mesh,
                     (COL_SPEC, P()), P(), (COL_SPEC, P()), (0, 1))(p, x)
    for r, o in enumerate(outs):
        got = o["tp_layers"]["col"]
        _close(got[0], y, f"rank {r} y")
        _close(got[1], _cols(g[0]["weight"], r, world), f"rank {r} dw")
        _close(got[2], _cols(g[0]["bias"], r, world), f"rank {r} db")
        _close(got[3], g[1], f"rank {r} dx")


@pytest.mark.parametrize("sp", [False, True], ids=["mlp", "sp_mlp"])
def test_column_row_mlp(ranks, sp):
    """column (no gather) → gelu → row (input_is_parallel), with and
    without sequence parallelism (the input and output sharded along the
    sequence; the row bias's gradient summed over tp by copy_to)."""
    world, d, outs = ranks
    name = "sp_mlp" if sp else "mlp"
    mesh = _mesh(world)
    col = JCol(16, 32, gather_output=False, sequence_parallel=sp)
    row = JRow(32, 16, input_is_parallel=True, sequence_parallel=sp)
    xs = P("tp") if sp else P()

    def mlp(pc, pr, x):
        return row.apply(pr, jax.nn.gelu(col.apply(pc, x)))

    args = (d[name]["pc"], d[name]["pr"], d[name]["x"])
    y, g = _fwd_grad(mlp, lambda y_, *a: jnp.sum(y_ ** 2), mesh,
                     (COL_SPEC, ROW_SPEC, xs), xs, (COL_SPEC, ROW_SPEC, xs),
                     (0, 1, 2))(*args)
    for r, o in enumerate(outs):
        got = o["tp_layers"][name]
        cut = (lambda a: _rows(a, r, world)) if sp else (lambda a: a)
        _close(got[0], cut(np.asarray(y)), f"rank {r} y")
        _close(got[1], _cols(g[0]["weight"], r, world), f"rank {r} col dw")
        _close(got[2], _cols(g[0]["bias"], r, world), f"rank {r} col db")
        _close(got[3], _rows(g[1]["weight"], r, world), f"rank {r} row dw")
        _close(got[4], g[1]["bias"], f"rank {r} row db")
        _close(got[5], cut(np.asarray(g[2])), f"rank {r} dx")


@pytest.mark.parametrize("sp", [False, True], ids=["emb", "sp_emb"])
def test_vocab_parallel_embedding(ranks, sp):
    """Each rank looks up the ids in its vocab range, the rest zeroed,
    and the ranks' outputs are summed (then scattered along the sequence
    under sequence parallelism); the weight's gradient lands on the
    owning rank's rows."""
    world, d, outs = ranks
    name = "sp_emb" if sp else "emb"
    mesh = _mesh(world)
    emb = JEmb(64, 8, sequence_parallel=sp)
    p, ids = d["emb"]["params"], d[name]["ids"]
    ys = P("tp") if sp else P()
    y, g = _fwd_grad(emb.apply, lambda y_, *a: jnp.sum(y_ ** 2), mesh,
                     (E_SPEC, P()), ys, E_SPEC, 0)(p, ids)
    for r, o in enumerate(outs):
        got = o["tp_layers"][name]
        _close(got[0], _rows(y, r, world) if sp else y, f"rank {r} y")
        _close(got[1], _rows(g["weight"], r, world), f"rank {r} dw")


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_vocab_parallel_cross_entropy(ranks, smoothing, fused):
    """The loss from vocab-sharded fp32 logits and each rank's gradient
    of its mean, both strategies, with and without label smoothing."""
    world, d, outs = ranks
    mesh = _mesh(world)
    lg, lb = d["xent"]["logits"], d["xent"]["labels"]

    def loss(a, b):
        return jxent(a, b, smoothing, fused=fused)

    want, g = _fwd_grad(loss, lambda y_, *a: jnp.mean(y_), mesh,
                        (P(None, "tp"), P()), P(), P(None, "tp"), 0)(lg, lb)
    for r, o in enumerate(outs):
        got = o["tp_layers"][f"xent{smoothing}{fused}"]
        _close(got[0], want, f"rank {r} loss")
        _close(got[1], _cols(g, r, world), f"rank {r} grad")


def test_vocab_parallel_cross_entropy_bf16(ranks):
    """bf16 logits take the fused path by default: the loss in fp32 and
    the gradient back in bf16, as the JAX package's."""
    world, d, outs = ranks
    mesh = _mesh(world)
    lg = jnp.asarray(d["xent"]["logits"]).astype(jnp.bfloat16)
    lb = d["xent"]["labels"]
    want, g = _fwd_grad(jxent, lambda y_, *a: jnp.mean(y_), mesh,
                        (P(None, "tp"), P()), P(), P(None, "tp"), 0)(lg, lb)
    for r, o in enumerate(outs):
        loss, grad, is_bf16 = o["tp_layers"]["xent_bf16"]
        assert is_bf16
        _close(loss, want, f"rank {r} loss")
        _close(grad, _cols(np.asarray(g, np.float32), r, world),
               f"rank {r} grad", dict(rtol=2e-2, atol=2e-3))


def test_sequence_parallel_layer_norm(ranks):
    """transformer.layers.LayerNorm with sequence_parallel_enabled: each
    rank normalizes its slice of the sequence, and the weight's and
    bias's gradients are the sums over the ranks, as the JAX package's
    copy_to makes them."""
    world, d, outs = ranks
    mesh = _mesh(world)
    ln = JLayerNorm(8, sequence_parallel_enabled=True)
    p = {"weight": d["ln"]["w"], "bias": d["ln"]["b"]}
    y, g = _fwd_grad(lambda p_, x, t: ln.apply(p_, x),
                     lambda y_, p_, x, t: jnp.sum(y_ * t), mesh,
                     (P(), P("tp"), P("tp")), P("tp"), P(), 0)(
        p, d["ln"]["x"], d["ln"]["t"])
    for r, o in enumerate(outs):
        got = o["tp_layers"]["ln"]
        _close(got[0], _rows(y, r, world), f"rank {r} y")
        _close(got[1], g["weight"], f"rank {r} dw")
        _close(got[2], g["bias"], f"rank {r} db")


def test_rng_and_activation_storage_over_tp(ranks):
    """model_parallel_fold_in gives every tp rank its own key: draws and
    dropout masks differ across ranks.  The distributed saved
    activations give the plain remat's gradients bit for bit, and a
    rank's 1-D chunk is its slice of the flattened activation, gathered
    back whole."""
    world, d, outs = ranks
    draws = {o["tp_layers"]["draw"].tobytes() for o in outs}
    masks = {o["tp_layers"]["mask"].tobytes() for o in outs}
    assert len(draws) == len(masks) == world
    flat = d["remat"]["x"].reshape(-1)
    per = flat.size // world
    for r, o in enumerate(outs):
        plain, distributed = o["tp_layers"]["remat"]
        for a, b in zip(plain, distributed):
            np.testing.assert_array_equal(a, b)
        chunk, gathered = o["tp_layers"]["split"]
        np.testing.assert_array_equal(chunk, flat[r * per:(r + 1) * per])
        np.testing.assert_array_equal(gathered, flat)
        assert "tp group" in o["tp_layers"]["bad_shard"]
        assert "not divisible" in o["tp_layers"]["ragged"]


def _dims(spec_tree):
    """A JAX PartitionSpec tree as the port's dims (the index of "tp",
    None for a replicated leaf)."""
    def dim(s):
        return next((i for i, e in enumerate(s) if e == "tp"), None)
    return jax.tree_util.tree_map(dim, spec_tree,
                                  is_leaf=lambda s: isinstance(s, P))


def test_partition_specs_and_init_match_jax():
    """Each layer's and GPT's `partition_spec` names the dim the JAX
    PartitionSpec shards over tp; `init` gives the JAX shapes, std and
    zero biases."""
    pairs = [(ColumnParallelLinear(8, 16), JCol(8, 16)),
             (RowParallelLinear(16, 8, init_std=0.5),
              JRow(16, 8, init_std=0.5)),
             (VocabParallelEmbedding(64, 8), JEmb(64, 8))]
    key = torch.Generator().manual_seed(0)
    for ours, theirs in pairs:
        assert ours.partition_spec() == _dims(theirs.partition_spec())
        p = ours.init(key)
        jp = theirs.init(jax.random.PRNGKey(0))
        assert {k: tuple(v.shape) for k, v in p.items()} == {
            k: v.shape for k, v in jp.items()}
        np.testing.assert_allclose(float(p["weight"].std()),
                                   float(jnp.std(jp["weight"])), rtol=0.3)
        if "bias" in p:
            assert not p["bias"].any()
    cfg = dict(vocab_size=64, seq_len=16, hidden=32, num_layers=2,
               num_heads=4)
    assert GPT(GPTConfig(**cfg)).partition_specs() == _dims(
        JaxGPT(JaxGPTConfig(**cfg)).partition_specs())


def test_tp_shard_without_a_group_and_sp_without_parallel_input_raise():
    """Without a tp group a layer is at tp = 1: a shard cut for more
    ranks raises rather than computing a part of the layer; sequence
    parallelism needs input_is_parallel, as in the JAX package."""
    from apex_tpu_torch.parallel import mesh as M

    M.destroy_model_parallel()
    col = ColumnParallelLinear(8, 16)
    with pytest.raises(ValueError, match="tp group"):
        col.apply({"weight": torch.zeros(8, 8), "bias": torch.zeros(8)},
                  torch.zeros(2, 8))
    y = col.apply({"weight": torch.ones(8, 16), "bias": torch.ones(16)},
                  torch.ones(2, 8))
    assert torch.equal(y, torch.full((2, 16), 9.0))
    with pytest.raises(RuntimeError, match="input_is_parallel"):
        RowParallelLinear(8, 8, input_is_parallel=False,
                          sequence_parallel=True)
    with pytest.raises(RuntimeError, match="input_is_parallel"):
        JRow(8, 8, input_is_parallel=False, sequence_parallel=True)
