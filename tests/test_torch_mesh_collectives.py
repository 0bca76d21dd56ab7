"""The port's tp process groups and Megatron region collectives
(apex_tpu_torch.parallel.mesh, .collectives) against the JAX package's
mesh and collectives, on the CPU.

The port runs as 2 and 4 gloo ranks started by its launcher (one
module-scoped world each, tests/torch_dist_worker.py); the JAX package
runs the same seeded numpy inputs on a mesh of the first 2 or 4 of its
8 CPU devices, the region pairs inside `shard_map`.  Mirrors
tests/test_mesh_collectives.py.  The group math and every exchange are
exact; the sums, fp32, within 1e-6 relative (the ranks' values added in
another order)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.parallel import collectives as JC
from apex_tpu.parallel import mesh as JM

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

WORLDS = (2, 4)

# name -> (x replicated?, x shape, t shape), n the world
SHAPES = {
    "copy_to_tensor_model_parallel_region":
        (True, lambda n: (4, 6), lambda n: (4, 6)),
    "reduce_from_tensor_model_parallel_region":
        (False, lambda n: (4, 6), lambda n: (4, 6)),
    "scatter_to_tensor_model_parallel_region":
        (True, lambda n: (4, 2 * n), lambda n: (4, 2)),
    "gather_from_tensor_model_parallel_region":
        (False, lambda n: (4, 2), lambda n: (4, 2 * n)),
    "scatter_to_sequence_parallel_region":
        (True, lambda n: (2 * n, 3), lambda n: (2, 3)),
    "gather_from_sequence_parallel_region":
        (False, lambda n: (2, 3), lambda n: (2 * n, 3)),
    "gather_from_sequence_parallel_region_no_tp_grad":
        (False, lambda n: (2, 3), lambda n: (2 * n, 3)),
    "reduce_scatter_to_sequence_parallel_region":
        (False, lambda n: (2 * n, 3), lambda n: (2, 3)),
}


def _inputs(world):
    rng = np.random.default_rng(11)

    def normal(shape):
        return rng.normal(size=shape).astype(np.float32)

    regions = {}
    for name, (rep, xs, ts) in SHAPES.items():
        x0 = normal(xs(world))
        regions[name] = {
            "x": [x0 if rep else normal(xs(world)) for _ in range(world)],
            "t": [normal(ts(world)) for _ in range(world)]}
    return {"scenarios": ["tp_mesh", "regions"],
            "tp_mesh": {"tps": [tp for tp in (1, 2, 4) if world % tp == 0]},
            "regions": dict(regions,
                            ring=[normal((2, 3)) for _ in range(world)],
                            halo=[normal((4, 2)) for _ in range(world)])}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    d = tmp_path_factory.mktemp(f"mesh{world}")
    inputs = _inputs(world)
    return world, inputs, W.run_ranks(str(d), world, inputs)


def _jmesh(world, tp):
    JM.destroy_model_parallel()
    return JM.initialize_model_parallel(tensor_model_parallel_size=tp,
                                        devices=jax.devices()[:world])


def test_group_rank_math_matches_the_jax_mesh(ranks):
    """For tp in {1, 2, 4} dividing the world: each rank's tp and dp
    sizes, ranks, source ranks and group members are the JAX mesh's
    (tp innermost: contiguous tp groups, strided dp groups), and a sum
    over each group is the sum over those members."""
    world, inputs, outs = ranks
    for tp in inputs["tp_mesh"]["tps"]:
        ids = np.vectorize(lambda dev: dev.id)(_jmesh(world, tp).devices)
        dp = world // tp
        assert ids.shape == (1, dp, tp)
        for r, o in enumerate(outs):
            got = o["tp_mesh"][tp]
            (_, dp_i, tp_i), = np.argwhere(ids == r)
            want = [tp, tp_i, dp, dp_i,
                    JM.get_tensor_model_parallel_src_rank(r),
                    JM.get_data_parallel_src_rank(r), tp, tp_i, dp, dp_i]
            np.testing.assert_array_equal(got["sizes"], want)
            np.testing.assert_array_equal(got["tp_ranks"], ids[0, dp_i])
            np.testing.assert_array_equal(got["dp_ranks"], ids[0, :, tp_i])
            np.testing.assert_array_equal(got["tp_sum"],
                                          [np.sum(ids[0, dp_i] + 1)])
            np.testing.assert_array_equal(got["dp_sum"],
                                          [np.sum(ids[0, :, tp_i] + 1)])
            np.testing.assert_array_equal(got["world_sum"],
                                          [world * (world + 1) / 2])
            assert got["info"] == f"proc{r} " + JM.get_rank_info().split(
                " ", 1)[1]
    JM.destroy_model_parallel()


def test_amax_axes_and_refusals(ranks):
    """reduce_amax is the max over the (dp, tp) plane; a tp or pp size
    that does not divide the world raises as the JAX mesh does, and so
    does a virtual pipeline at pp = 1 and an ep size that does not divide
    the world (the JAX message names it), and a context_parallel_size
    argument is a TypeError, as the JAX function (which has none)
    gives."""
    world, _, outs = ranks
    JM.destroy_model_parallel()
    JM.initialize_model_parallel(devices=jax.devices()[:world], use_fp8=True)
    axes = (JM.get_amax_reduction_axes(), JM.get_model_parallel_axes())
    JM.destroy_model_parallel()
    with pytest.raises(ValueError):
        JM.initialize_model_parallel(tensor_model_parallel_size=3,
                                     devices=jax.devices()[:world])
    for o in outs:
        np.testing.assert_array_equal(o["tp_mesh"]["amax"], [world - 1])
        assert o["tp_mesh"]["axes"] == axes
        refused = o["tp_mesh"]["refused"]
        assert "not divisible by tp(3)" in refused["tp3"]
        assert "not divisible by tp(1) x pp(3)" in refused["pp"]
        assert "requires pipeline_model_parallel_size >= 2" in \
            refused["vpp"]
        assert "context_parallel_size" in refused["cp"], refused
        assert "not divisible by tp(1) x pp(1) x ep(3)" in refused["ep"], \
            refused
    with pytest.raises(ValueError, match="pp\\(3\\)"):
        JM.initialize_model_parallel(pipeline_model_parallel_size=3,
                                     devices=jax.devices()[:world])
    with pytest.raises(ValueError, match="pipeline_model_parallel_size >= 2"):
        JM.initialize_model_parallel(virtual_pipeline_model_parallel_size=2,
                                     devices=jax.devices()[:world])
    with pytest.raises(ValueError, match=r"x pp\(1\) x ep\(3\)"):
        JM.initialize_model_parallel(expert_model_parallel_size=3,
                                     devices=jax.devices()[:world])


def _jax_region(fn, xs, ts, world):
    """Each rank's fn(x) and the gradient of sum(fn(x) * t) inside
    shard_map over a tp = world mesh, stacked by rank."""
    mesh = _jmesh(world, world)

    def local(x, t):
        y, vjp = jax.vjp(lambda a: fn(a, "tp"), x[0])
        g, = vjp(t[0])
        return y[None], g[None]

    return jax.jit(shard_map(local, mesh=mesh, in_specs=(P("tp"), P("tp")),
                             out_specs=(P("tp"), P("tp")),
                             check_vma=False))(jnp.stack(xs), jnp.stack(ts))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_region_pair_forward_and_backward(ranks, name):
    """Each of the region pairs, forward and backward, on every rank, as
    the JAX package's custom_vjp pair computes it."""
    world, inputs, outs = ranks
    d = inputs["regions"][name]
    y, g = _jax_region(getattr(JC, name), d["x"], d["t"], world)
    for r, o in enumerate(outs):
        got_y, got_g = o["regions"][name]
        np.testing.assert_allclose(got_y, np.asarray(y[r]), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{name} rank {r} y")
        np.testing.assert_allclose(got_g, np.asarray(g[r]), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{name} rank {r} dx")
    JM.destroy_model_parallel()


def test_ring_and_halo_exchange(ranks):
    """ring_exchange with shifts +1 and -1 and halo_exchange_1d's two
    slabs, as the JAX ppermutes deliver them; a reduce-scatter along a
    dimension the group does not divide raises, as psum_scatter does."""
    world, inputs, outs = ranks
    mesh = _jmesh(world, world)
    d = inputs["regions"]

    def per_rank(fn, xs):
        return np.asarray(jax.jit(shard_map(
            lambda a: fn(a[0])[None], mesh=mesh, in_specs=P("tp"),
            out_specs=P("tp"), check_vma=False))(jnp.stack(xs)))

    plus = per_rank(lambda a: JC.ring_exchange(a, "tp", 1), d["ring"])
    minus = per_rank(lambda a: JC.ring_exchange(a, "tp", -1), d["ring"])
    halo = per_rank(lambda a: jnp.concatenate(JC.halo_exchange_1d(
        a, "tp", halo=1)), d["halo"])
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["regions"]["ring+1"], plus[r])
        np.testing.assert_array_equal(o["regions"]["ring-1"], minus[r])
        np.testing.assert_array_equal(o["regions"]["halo"], halo[r])
        assert "not divisible" in o["regions"]["ragged"]
    with pytest.raises(Exception):
        jax.jit(shard_map(
            lambda a: JC.reduce_scatter_to_sequence_parallel_region(a),
            mesh=mesh, in_specs=P(), out_specs=P("tp"), check_vma=False))(
            jnp.ones((2 * world + 1, 3)))
    JM.destroy_model_parallel()


def test_world_of_one_collectives_are_the_identity():
    """Without torch.distributed every region pair is the identity (the
    same tensor back, no Function entered) and a P2P exchange returns
    the rank's own slabs."""
    from apex_tpu_torch.parallel import collectives as C
    from apex_tpu_torch.parallel import mesh as M

    M.destroy_model_parallel()
    x = torch.arange(6.0).reshape(2, 3)
    for name in SHAPES:
        assert getattr(C, name)(x) is x
    assert torch.equal(C.ring_exchange(x, "tp", 1), x)
    left, right = C.halo_exchange_1d(x, "tp", halo=1)
    assert torch.equal(left, x[1:]) and torch.equal(right, x[:1])
    M.initialize_model_parallel()
    assert (M.get_tensor_model_parallel_group(),
            M.get_tensor_model_parallel_world_size(),
            M.get_tensor_model_parallel_rank()) == (None, 1, 0)
    assert M.new_process_group(("pp", "tp")) is None
    # at ep = 1 "ep" names no group of its own: ("dp", "ep") is dp's
    assert M.new_process_group("ep") is None
    assert M.new_process_group(("dp", "ep")) is None
    with pytest.raises(ValueError, match="unknown mesh axes"):
        M.new_process_group("cp")
    with pytest.raises(M.MeshNotInitializedError, match="use_fp8"):
        M.get_amax_reduction_axes()
    M.destroy_model_parallel()
