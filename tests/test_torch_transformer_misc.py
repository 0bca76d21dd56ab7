"""The rest of the port's transformer package against the JAX
package's, on the CPU: the Megatron batch samplers (index streams bit
for bit), `testing` (parse_args namespaces, ToyParallelMLP at tp 1 in
fp32 at rtol 1e-5, the globals), `tensor_parallel.data.broadcast_data`
(the dtype error; a 2-rank gloo world through tests/torch_dist_worker.py
in which rank 1 ends with rank 0's batch), `tensor_parallel.memory`
(offsets, views of one arena, errors, counters) and `_backend_util`."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.transformer import _backend_util as jbu
from apex_tpu.transformer._data import (
    MegatronPretrainingRandomSampler as JRandom,
    MegatronPretrainingSampler as JSeq)
from apex_tpu.transformer.tensor_parallel import data as jdata
from apex_tpu.transformer.tensor_parallel import memory as jmem
from apex_tpu.transformer.testing import arguments as jargs
from apex_tpu.transformer.testing import commons as jcommons
from apex_tpu_torch.transformer import _backend_util as bu
from apex_tpu_torch.transformer._data import (
    MegatronPretrainingRandomSampler, MegatronPretrainingSampler)
from apex_tpu_torch.transformer.tensor_parallel import broadcast_data
from apex_tpu_torch.transformer.tensor_parallel import memory
from apex_tpu_torch.transformer import testing
from apex_tpu_torch.transformer.testing import arguments

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402


# ------------------------------ samplers ------------------------------

@pytest.mark.parametrize("dp", [1, 2, 4])
@pytest.mark.parametrize("consumed", [0, 24])
@pytest.mark.parametrize("drop_last", [True, False])
def test_pretraining_sampler_streams_match(dp, consumed, drop_last):
    for rank in range(dp):
        args = (101, consumed, 3, rank, dp)
        got = list(MegatronPretrainingSampler(*args, drop_last=drop_last))
        want = list(JSeq(*args, drop_last=drop_last))
        assert got == want and len(got) > 0


@pytest.mark.parametrize("dp", [1, 2, 4])
@pytest.mark.parametrize("consumed", [0, 24, 120])
def test_random_sampler_streams_match(dp, consumed):
    """Epoch 0 from the start and mid-epoch, and (120 of 96 active
    samples) the second epoch mid-way."""
    for rank in range(dp):
        args = (100, consumed, 3, rank, dp)
        s, j = MegatronPretrainingRandomSampler(*args), JRandom(*args)
        assert list(s) == list(j)
        assert s.consumed_samples == j.consumed_samples
        assert s.epoch == j.epoch


# ------------------------------ testing ------------------------------

@pytest.mark.parametrize("argv", [
    [],
    ["--num-layers", "4", "--hidden-size", "64", "--num-attention-heads",
     "8", "--fp16", "--lr", "1e-3", "--optimizer", "lamb"],
    ["--micro-batch-size", "2", "--global-batch-size", "16",
     "--rampup-batch-size", "4", "4", "100", "--data-path", "a", "b",
     "--tensor-model-parallel-size", "2", "--sequence-parallel",
     "--distributed-backend", "nccl", "--seq-length", "128"],
])
def test_parse_args_namespaces_match(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "8")
    got = vars(arguments.parse_args(defaults={"seq_length": 32,
                                              "lr": 0.5}))
    want = vars(jargs.parse_args(defaults={"seq_length": 32, "lr": 0.5}))
    assert got == want
    assert got["rank"] == 3 and got["world_size"] == 8


def test_parse_args_extra_provider_and_unknown(monkeypatch):
    def extra(parser):
        parser.add_argument("--my-flag", type=int, default=7)
        return parser

    monkeypatch.setattr(sys, "argv", ["prog", "--bogus", "1"])
    got = vars(arguments.parse_args(extra, ignore_unknown_args=True))
    want = vars(jargs.parse_args(extra, ignore_unknown_args=True))
    assert got == want and got["my_flag"] == 7
    with pytest.raises(SystemExit):
        arguments.parse_args()


def test_global_variables(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog", "--num-layers", "2"])
    args = testing.set_global_variables()
    assert testing.get_args() is args and args.num_layers == 2
    from apex_tpu_torch.utils import Timers
    assert isinstance(testing.get_timers(), Timers)


def test_toy_parallel_mlp_matches_jax_at_tp1():
    """The JAX ToyParallelMLP's params through the port's (tp 1, fp32),
    rtol 1e-5; the gelu is the tanh form on both sides."""
    jm = jcommons.ToyParallelMLP(16)
    jp = jm.init(jax.random.PRNGKey(0))
    x = np.random.RandomState(0).randn(5, 16).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    fwd = shard_map(jm.apply, mesh=mesh, in_specs=(P(), P()),
                    out_specs=P(), check_vma=False)
    want = np.asarray(fwd(jp, jnp.asarray(x)))
    pt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    got = testing.ToyParallelMLP(16).apply(pt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_toy_modules_and_seed():
    g = testing.set_random_seed(3)
    assert isinstance(g, torch.Generator)
    a = np.random.rand()
    testing.set_random_seed(3)
    assert np.random.rand() == a
    layer = testing.IdentityLayer((2, 3), scale=2.0)
    p = layer.init(torch.Generator().manual_seed(0), device="cpu")
    assert layer.apply(p).shape == (2, 3)
    model = testing.MyModel(4, num_layers=3)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    jparams = [{k: jnp.asarray(v.numpy()) for k, v in q.items()}
               for q in params]
    x = np.ones((2, 4), np.float32)
    np.testing.assert_allclose(
        model.apply(params, torch.from_numpy(x)).numpy(),
        np.asarray(jcommons.MyModel(4, 3).apply(jparams, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)
    from apex_tpu_torch.models.bert import Bert
    from apex_tpu_torch.models.gpt import GPT
    assert testing.StandaloneGPT is GPT and testing.StandaloneBert is Bert



@pytest.mark.parametrize("make", [
    lambda: testing.IdentityLayer((2, 3)),
    lambda: testing.MyLayer(4),
    lambda: testing.MyModel(4, num_layers=2),
    lambda: testing.ToyParallelMLP(4)],
    ids=["IdentityLayer", "MyLayer", "MyModel", "ToyParallelMLP"])
def test_toy_init_without_a_device_is_on_the_card(make):
    """`init` with no device puts the parameters on the card; with no
    card it raises rather than leave them on the CPU."""
    key = torch.Generator().manual_seed(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make().init(key)
        return
    params = make().init(key)
    leaves = params if isinstance(params, list) else [params]
    assert all(t.is_cuda for q in leaves for v in q.values()
               for t in (v.values() if isinstance(v, dict) else [v]))


# ------------------------------ data ------------------------------

def test_broadcast_data_dtype_error_matches():
    data = {"text": np.zeros((2, 3), np.int64)}
    with pytest.raises(ValueError) as e:
        broadcast_data(["text"], data, torch.int32, device="cpu")
    with pytest.raises(ValueError) as je:
        jdata.broadcast_data(["text"], data, jnp.int32)
    assert str(e.value) == ("text has data type torch.int64 which is "
                            "different than torch.int32")
    assert str(je.value) == ("text has data type int64 which is "
                             "different than <class 'jax.numpy.int32'>")


def test_broadcast_data_one_process_selects_and_moves():
    data = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": np.ones(4, np.int32), "skip": "not a tensor"}
    got = broadcast_data(["a", "b"], data, device="cpu")
    want = jdata.broadcast_data(["a", "b"], data)
    assert sorted(got) == sorted(want) == ["a", "b"]
    for k in got:
        assert got[k].device.type == "cpu" and got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_broadcast_data_across_two_ranks(tmp_path):
    """Rank r passes its own batch (values + r); both end with rank 0's
    (the JAX package's broadcast_one_to_all); one broadcast a key over
    the world, reported to the comms inventory as one all-reduce, as the
    JAX package spells it; only rank 0 warns."""
    rng = np.random.RandomState(5)
    batch = {"text": rng.randint(0, 100, (2, 8)).astype(np.int32),
             "labels": rng.randint(0, 100, (2, 8)).astype(np.int32)}
    outs = W.run_ranks(str(tmp_path), 2, {"scenarios": ["broadcast"],
                                          "broadcast": {"batch": batch}})
    for o in outs:
        r = o["broadcast"]
        for k in batch:
            np.testing.assert_array_equal(r["got"][k], batch[k])
        assert r["kinds"] == ["all-reduce", "all-reduce"]
        assert r["group_sizes"] == [2, 2]
    assert [o["broadcast"]["warned"] for o in outs] == [1, 0]



@pytest.mark.parametrize("name", ["broadcast.3", "broadcast_in_dim.7"])
def test_hlo_broadcast_is_not_a_collective(name):
    """An XLA broadcast instruction in a JAX-form trace is "other" in
    both packages' timelines, and the port's collective kinds are the
    JAX package's five."""
    from apex_tpu.monitor.comms.hlo import COLLECTIVE_KINDS as JKINDS
    from apex_tpu.monitor.timeline.report import classify_op as jclassify
    from apex_tpu_torch.monitor.comms.hlo import COLLECTIVE_KINDS
    from apex_tpu_torch.monitor.timeline.report import (classify_op,
                                                        collective_kind)

    assert COLLECTIVE_KINDS == JKINDS
    assert jclassify(name) == classify_op(name) == "other"
    assert jclassify("fusion.1", name) == classify_op("fusion.1", name) \
        == "other"
    assert collective_kind(name) is None


# ------------------------------ memory ------------------------------

def test_memory_buffer_views_offsets_and_errors():
    buf = memory.MemoryBuffer("act", 24, torch.float32, track_usage=True,
                              device="cpu")
    jbuf = jmem.MemoryBuffer("act", 24, jnp.float32, track_usage=True)
    assert not buf.is_in_use()
    for shape in ((2, 3), (4,), (1, 2, 5)):
        v, jv = buf.add(shape), jbuf.add(shape)
        assert tuple(v.shape) == tuple(jv.shape) == shape
        assert buf._start == jbuf._start
        assert v.untyped_storage().data_ptr() == \
            buf.get_data().untyped_storage().data_ptr()
    v.fill_(7.0)                       # a view: the arena sees the write
    assert float(buf.get_data()[10:20].sum()) == 70.0
    assert (buf.in_use_value, buf.total_value) == (jbuf.in_use_value,
                                                   jbuf.total_value) == (20, 20)
    for b in (buf, jbuf):
        with pytest.raises(RuntimeError, match="MemoryBuffer out of space"):
            b.add((5,))
    buf.reset()
    assert not buf.is_in_use() and buf.add((24,)).shape == (24,)


def test_ring_mem_buffer_round_robin_and_in_use():
    ring = memory.RingMemBuffer("ring", 2, 8, torch.bfloat16, device="cpu")
    jring = jmem.RingMemBuffer("ring", 2, 8, jnp.bfloat16)
    for r in (ring, jring):
        a = r.get_next_buffer()
        a.add((4,))
        b = r.get_next_buffer()
        assert b is not a and b.name == "ring 1"
        with pytest.raises(RuntimeError, match="buffer is already in use"):
            r.get_next_buffer()
        a.reset()               # the failed call still took a's turn
        assert r.get_next_buffer() is b
        assert r.get_next_buffer() is a
    assert ring.buffers[0].data.dtype == torch.bfloat16


# ---------------------------- backend util ----------------------------

def test_backend_util_answers_for_this_process():
    assert bu.HAS_UCC is bool(torch.distributed.is_ucc_available())
    assert jbu.HAS_UCC is False
    assert bu.backend_available("cpu") and jbu.backend_available("cpu")
    assert bu.backend_available("tpu") is False
    assert bu.backend_available("gpu") == torch.cuda.is_available()
    assert bu.default_backend() == ("gpu" if torch.cuda.is_available()
                                    else "cpu")
