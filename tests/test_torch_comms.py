"""The port's comms observatory (apex_tpu_torch.monitor.comms) against
the JAX package's, on the CPU.

  * the link roofline: `collective_seconds` and the bandwidth
    resolution equal the JAX functions' outputs (exactly: the same
    float formulas) over kinds, sizes, group sizes and device kinds;
  * the schema, gate and table over the JAX package's committed report
    (scripts/comms_fixture.json, read only): both validators, the
    allowlist and the rendered table give the same answers and text;
  * the inventory recorder: in ONE 2-rank gloo world (scenario `comms`
    of tests/torch_dist_worker.py) `comms_report` of the tp = 2 Megatron
    MLP, forward and backward, with and without sequence parallelism,
    lists the collectives (kind, dtype, operand and output bytes, group
    size, axes) that the JAX `comms_report(optimized=False)` of the same
    layers in `shard_map` on 2 CPU devices lists, as multisets (the
    names differ: the JAX ones are HLO instruction names); and
    `crosscheck_comms` over a captured gloo trace returns UNMEASURED
    rows with `ok` true.
"""

import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.monitor import comms as jcomms
from apex_tpu.monitor.comms import roofline as jroof
from apex_tpu.parallel import mesh as JM
from apex_tpu.transformer.tensor_parallel import (
    ColumnParallelLinear as JCol,
    RowParallelLinear as JRow,
)
from apex_tpu_torch import monitor
from apex_tpu_torch.monitor import comms
from apex_tpu_torch.monitor.comms import inventory, roofline
from apex_tpu_torch.parallel import mesh as M

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "scripts" / "comms_fixture.json"
WORLD = 2
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "psum")


# ------------------------------ roofline ------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("group", [0, 1, 2, 3, 8, 256])
def test_collective_seconds_equals_jax(kind, group):
    for nbytes in (0, 1, 4096, 3 << 20, 10 ** 9):
        for bw in (0.0, 62e9, 200e9, 900e9):
            assert roofline.collective_seconds(kind, nbytes, group, bw) \
                == jroof.collective_seconds(kind, nbytes, group, bw)


@pytest.mark.parametrize("kind", [None, "", "cpu", "TPU v2", "TPU v3",
                                  "TPU v4", "TPU v5 lite", "TPU v5e",
                                  "TPU v5p", "TPU v6e", "Trillium",
                                  "some future chip"])
def test_bandwidth_resolution_equals_jax_on_its_kinds(kind):
    assert roofline.resolve_link_bandwidth(kind) \
        == jroof.resolve_link_bandwidth(kind)
    assert roofline.resolve_link_bandwidth(kind, override=5e9) \
        == jroof.resolve_link_bandwidth(kind, override=5e9)
    if kind is not None:
        assert roofline.device_link_bandwidth(kind) \
            == jroof.device_link_bandwidth(kind)


def test_nvlink_rows_are_the_data_sheet_peaks():
    """The port's own rows, under the flops table's keys."""
    assert roofline.resolve_link_bandwidth("NVIDIA H100 80GB HBM3") == (
        900e9, "table:h100-sxm")
    assert roofline.resolve_link_bandwidth("NVIDIA H100 PCIe") == (
        600e9, "table:h100-pcie")
    assert set(roofline.DEVICE_ICI_BANDWIDTH) - set(
        jroof.DEVICE_ICI_BANDWIDTH) == {"h100-sxm", "h100-pcie"}
    assert roofline.V5E_ICI_BYTES_PER_S == jroof.V5E_ICI_BYTES_PER_S


# ----------------------- schema, gate and table -----------------------

def _fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def test_fixture_validates_gates_and_renders_as_jax():
    rep = _fixture()
    comms.validate_comms_report(rep)
    jcomms.validate_comms_report(rep)
    assert comms.serialized_collectives(rep) \
        == jcomms.serialized_collectives(rep)
    assert comms.render_comms_table(rep, label="fixture") \
        == jcomms.render_comms_table(rep, label="fixture")
    text = "\n".join(["all-reduce fixture:*", "# a comment",
                      "all-to-all *permute*", "reduce-scatter"])
    entries = comms.parse_allowlist(text)
    assert entries == jcomms.parse_allowlist(text)
    ser = comms.serialized_collectives(rep)
    assert comms.apply_allowlist(ser, entries, "fixture") \
        == jcomms.apply_allowlist(ser, entries, "fixture")
    with pytest.raises(ValueError, match="unknown collective kind"):
        comms.parse_allowlist("psum *")


def _drift(rep):
    """(name, mutated report) pairs each validator must refuse."""
    out = [("version", dict(rep, comms_schema_version=99)),
           ("missing", {k: v for k, v in rep.items()
                        if k != "total_comm_bytes"}),
           ("bool", dict(rep, total_comm_bytes=True)),
           ("type", dict(rep, overlap_ok="yes"))]
    bad = json.loads(json.dumps(rep))
    bad["collectives"][0]["kind"] = "psum"
    out.append(("kind", bad))
    bad = json.loads(json.dumps(rep))
    del bad["collectives"][0]["op_name"]
    out.append(("field", bad))
    return out


@pytest.mark.parametrize("case", range(6))
def test_both_validators_refuse_the_same_drift(case):
    name, bad = _drift(_fixture())[case]
    for validate in (comms.validate_comms_report,
                     jcomms.validate_comms_report):
        with pytest.raises(ValueError):
            validate(bad)


def test_rank_timing_crosscheck_equals_jax():
    rep = _fixture()
    rng = np.random.default_rng(3)
    t = rng.uniform(1e-4, 1e-3, size=(4, 5))
    assert comms.crosscheck_rank_timing(rep, t) \
        == jcomms.crosscheck_rank_timing(rep, t)
    assert comms.crosscheck_rank_timing(rep, t[:, 0]) \
        == jcomms.crosscheck_rank_timing(rep, t[:, 0])


# ------------------------- the wrappers' hook -------------------------

def test_no_observer_outside_a_recording():
    """Nothing observes the wrappers unless a recording or a capture is
    open; the world of one issues nothing."""
    assert M._OBSERVER is None
    rec = inventory.InventoryRecorder()
    with inventory.recording(rec):
        assert M._OBSERVER is not None
        x = torch.ones(4)
        assert M.all_reduce(x, "sum", None) is x      # no group: identity
    assert M._OBSERVER is None and rec.entries == []
    with inventory.annotating():
        assert M._OBSERVER is not None
    assert M._OBSERVER is None


def test_comms_report_without_a_world_lists_nothing():
    rep = monitor.comms_report(lambda x: x * 2, (torch.ones(3),))
    comms.validate_comms_report(json.loads(json.dumps(rep.to_dict())))
    assert rep.collectives == [] and rep.counts == {}
    assert rep.async_supported is False and rep.overlap_ok is True
    assert rep.mesh_axis_names == ("dp",) and rep.backend == "cpu"
    with pytest.raises(NotImplementedError, match="HLO"):
        monitor.comms_report(hlo_text="HloModule m")


# ------------------------ the 2-rank inventory ------------------------

def _inputs():
    rng = np.random.default_rng(24)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def lin(i, o):
        return {"weight": normal(i, o, scale=i ** -0.5),
                "bias": normal(o, scale=0.1)}

    return {"scenarios": ["comms"],
            "comms": {"pc": lin(16, 32), "pr": lin(32, 16),
                      "x": normal(4 * WORLD, 16)}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = _inputs()
    outs = W.run_ranks(str(tmp_path_factory.mktemp("comms")), WORLD, d)
    return d["comms"], [o["comms"] for o in outs]


COL_SPEC = {"weight": P(None, "tp"), "bias": P("tp")}
ROW_SPEC = {"weight": P("tp", None), "bias": P()}


def _jax_inventory(d, sp):
    """The JAX pre-optimization inventory of the same MLP, its output
    and the gradient of a second forward's loss taken in one shard_map
    (tests/test_torch_tensor_parallel.py's harness)."""
    JM.destroy_model_parallel()
    mesh = JM.initialize_model_parallel(tensor_model_parallel_size=WORLD,
                                        devices=jax.devices()[:WORLD])
    col = JCol(16, 32, gather_output=False, sequence_parallel=sp)
    row = JRow(32, 16, input_is_parallel=True, sequence_parallel=sp)
    xs = P("tp") if sp else P()

    def mlp(pc, pr, x):
        return row.apply(pr, jax.nn.gelu(col.apply(pc, x)))

    def local(pc, pr, x):
        return mlp(pc, pr, x), jax.grad(
            lambda *b: jnp.sum(mlp(*b) ** 2), argnums=(0, 1, 2))(pc, pr, x)

    f = jax.jit(shard_map(local, mesh=mesh,
                          in_specs=(COL_SPEC, ROW_SPEC, xs),
                          out_specs=(xs, (COL_SPEC, ROW_SPEC, xs)),
                          check_vma=False))
    rep = jcomms.comms_report(f, (d["pc"], d["pr"], d["x"]), mesh=mesh,
                              optimized=False)
    JM.destroy_model_parallel()
    return rep


@pytest.mark.parametrize("sp", [False, True], ids=["mlp", "sp_mlp"])
def test_inventory_equals_jax_shard_map(ranks, sp):
    d, outs = ranks
    name = "sp_mlp" if sp else "mlp"
    jrep = _jax_inventory(d, sp)
    want = sorted((c.kind, c.dtype, c.operand_bytes, c.output_bytes,
                   c.group_size, c.axes) for c in jrep.collectives)
    assert want, "the JAX program issues collectives"
    for r, o in enumerate(outs):
        got = sorted(tuple(c) for c in o[name]["collectives"])
        assert got == want, f"rank {r}"
        rep = o[name]["report"]
        comms.validate_comms_report(rep)
        jcomms.validate_comms_report(rep)
        assert rep["counts"] == jrep.counts
        assert rep["bytes_by_kind"] == jrep.bytes_by_kind
        assert rep["mesh_axis_names"] == list(jrep.mesh_axis_names)
        assert rep["mesh_axis_sizes"] == list(jrep.mesh_axis_sizes)
        # gloo's collectives are sync, as XLA's are on the CPU
        assert rep["async_supported"] is False
        assert rep["async_supported"] == jrep.async_supported
        assert [c["name"] for c in rep["collectives"]] == [
            f"{c['kind']}.{i}" for i, c in enumerate(rep["collectives"])]
        assert rep["compute_s"] is not None and rep["compute_s"] > 0
        assert "=== comms: " + name in o[name]["table"]


@pytest.mark.parametrize("sp", [False, True], ids=["mlp", "sp_mlp"])
def test_crosscheck_over_a_gloo_trace_is_unmeasured(ranks, sp):
    _, outs = ranks
    name = "sp_mlp" if sp else "mlp"
    for o in outs:
        tl, xc = o[name]["timeline"], o[name]["crosscheck"]
        monitor.validate_timeline_report(tl)
        assert tl["device_type"] == "cpu" and not tl["overlap_measurable"]
        assert xc["ok"] is True and xc["n_diverge"] == 0
        rows = xc["rows"]
        assert len(rows) == len(o[name]["collectives"]) > 0
        assert all(r["verdict"] == "UNMEASURED" for r in rows)
