"""The port's eight examples that are twins of the JAX package's
(examples/torch_<name>.py), run in process through `main(argv)` with
`--device cpu` at tiny sizes: each prints its JAX twin's lines and
returns its exit code or numbers.  Also: the DCGAN example's networks
against the JAX example's on the same HWIO weights (fp32, rtol 1e-5),
which holds its transposed convolution to `lax.conv_transpose`; every
JAX example has a twin; no port example imports JAX."""

import json
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))

import torch_bench_bert  # noqa: E402
import torch_bench_optimizers  # noqa: E402
import torch_dcgan_amp  # noqa: E402
import torch_gpt_scaling_test  # noqa: E402
import torch_imagenet_amp  # noqa: E402
import torch_serve_gpt  # noqa: E402
import torch_simple_distributed  # noqa: E402
import torch_zero_memory_report  # noqa: E402

FLOAT = r"[-+]?\d+\.\d+(?:e[-+]?\d+)?"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_simple_distributed(capsys):
    losses = torch_simple_distributed.main(["--device", "cpu"])
    out = _lines(capsys)
    assert out[0] == "mesh: {'pp': 1, 'dp': 1, 'tp': 1}"
    assert [re.fullmatch(rf"step (\d+): loss {FLOAT}", ln).group(1)
            for ln in out[1:5]] == ["0", "5", "10", "15"]
    assert re.fullmatch(rf"final loss: {FLOAT}", out[5])
    assert len(losses) == 20 and losses[-1] < 1e-3 * losses[0]


def test_bench_optimizers(capsys):
    recs = torch_bench_optimizers.main(["--device", "cpu"])
    (line,) = _lines(capsys)
    rec = json.loads(line)
    assert rec == recs[0]
    assert sorted(rec) == ["dtype", "gb_per_s", "metric", "unit", "value",
                           "vs_baseline"]
    assert rec["metric"] == "fused_adam_step_ms_at_0.001B_params"
    assert rec["dtype"] == "float32" and rec["gb_per_s"] is None
    assert rec["value"] > 0


def test_imagenet_amp_resnet18(capsys, tmp_path):
    from apex_tpu_torch.checkpoint import load_checkpoint

    res = torch_imagenet_amp.main([
        "--device", "cpu", "--arch", "resnet18", "--image-size", "32",
        "--batch-size", "4", "--iters", "2", "--print-freq", "1",
        "--save", str(tmp_path / "ck")])
    out = _lines(capsys)
    assert out[0] == "devices: 1  mesh dp=1"
    for ln in out[1:3]:
        assert re.fullmatch(
            rf"iter \d+  loss {FLOAT}  Speed {FLOAT} img/sec  time/iter "
            rf"{FLOAT} ms  loss_scale 65536", ln), ln
    assert out[3] == f"saved to {tmp_path / 'ck'}"
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    saved = load_checkpoint(str(tmp_path / "ck"))
    assert sorted(saved) == ["amp", "model_state", "opt_state"]


def test_bench_bert(capsys):
    res = torch_bench_bert.main(["--device", "cpu"])
    (line,) = _lines(capsys)
    rec = json.loads(line)
    assert rec == res["record"]
    assert rec["metric"] == "bert_large_lamb_seqs_per_sec_per_chip"
    assert sorted(rec) == ["metric", "s_per_iter", "unit", "value",
                           "vs_baseline"]
    assert len(res["losses"]) == 4 and all(np.isfinite(res["losses"]))


def test_bench_bert_sweep_needs_the_card(capsys):
    with pytest.raises(SystemExit) as e:
        torch_bench_bert.main(["--device", "cpu", "--batch-sweep", "2,4"])
    assert e.value.code == 2


def test_gpt_scaling(capsys):
    res = torch_gpt_scaling_test.main([
        "--device", "cpu", "--steps", "1", "--batch-size", "2",
        "--seq-len", "32"])
    (line,) = _lines(capsys)
    assert re.fullmatch(rf"hidden=128 params=\d+M  Average Iteration Time: "
                        rf"{FLOAT} s  \(\d+ tokens/s\)", line), line
    assert len(res) == 1 and len(res[0]["losses"]) == 2
    assert all(np.isfinite(res[0]["losses"]))


def test_dcgan_amp(capsys):
    res = torch_dcgan_amp.main(["--device", "cpu", "--batch-size", "4",
                                "--iters", "2"])
    out = _lines(capsys)
    for i, ln in enumerate(out[:2]):
        assert re.fullmatch(rf"\[{i}/2\] Loss_D {FLOAT} Loss_G {FLOAT} "
                            rf"scale \d+", ln), ln
    assert re.fullmatch(rf"2 iters in {FLOAT}s \(\d+ img/s\)", out[2])
    assert re.fullmatch(rf"after the first: 1 iters in {FLOAT}s "
                        rf"\(\d+ img/s\)", out[3])
    assert res["first_iter_s"] > 0 and res["img_per_s_after_first"] > 0
    assert all(np.isfinite(res["loss_d"] + res["loss_g"]))


def test_dcgan_networks_match_the_jax_example():
    """G and D on the same HWIO weights (fp32, no policy): the port's
    flipped-kernel conv_transpose2d is `lax.conv_transpose`, its SAME /
    VALID paddings the JAX example's."""
    import dcgan_amp as jex

    rng = np.random.RandomState(0)
    for image_size in (32,):
        jg, jd = jex.Generator(image_size, nz=6, ngf=4), \
            jex.Discriminator(image_size, ndf=4)
        g = torch_dcgan_amp.Generator(image_size, nz=6, ngf=4)
        d = torch_dcgan_amp.Discriminator(image_size, ndf=4)
        gp = g.init(torch.Generator().manual_seed(1), "cpu")
        dp = d.init(torch.Generator().manual_seed(2), "cpu")

        def as_jax_leaf(tree):
            return {k: (as_jax_leaf(v) if isinstance(v, dict)
                        else jnp.asarray(v.numpy())) for k, v in
                    tree.items()}

        jgp = [as_jax_leaf(gp[f"l{i}"]) for i in range(len(gp))]
        jdp = [as_jax_leaf(dp[f"l{i}"]) for i in range(len(dp))]
        z = rng.randn(3, 6, 1, 1).astype(np.float32)
        img = g(gp, torch.from_numpy(z))
        jimg = jg(jgp, jnp.asarray(z.transpose(0, 2, 3, 1)))
        np.testing.assert_allclose(img.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(jimg), rtol=1e-5, atol=1e-5)
        logits = d(dp, img)
        np.testing.assert_allclose(logits.numpy(),
                                   np.asarray(jd(jdp, jimg)), rtol=1e-5,
                                   atol=1e-5)


def test_serve_gpt_runs_its_drain_and_its_slo_gate(capsys):
    assert torch_serve_gpt.main(["--device", "cpu"]) == 0
    out = _lines(capsys)
    assert re.fullmatch(r"engine: 64 slots, \d+ pages x 8 tokens, pool "
                        rf"{FLOAT} MiB \(\d+ KiB per user worst-case\)",
                        out[0])
    assert re.match(r"decoded 64 requests / 1024 tokens in ", out[1])
    assert out[4].startswith("sentry: ") and out[5].startswith("ledger: ")
    assert out[-1] == "serve_gpt: OK (zero steady-state recompiles)"
    assert torch_serve_gpt.main(["--device", "cpu", "--drain-after-steps",
                                 "3"]) == 0
    out = _lines(capsys)
    assert re.fullmatch(r"drain: \d+ live finished, \d+ queued request\(s\) "
                        r"in the restorable snapshot \(serve_state_version "
                        r"\d+\)", out[1])
    assert out[-1] == "serve_gpt: drain OK (no live request lost)"
    # an SLO no run can meet: the breach is the exit code
    assert torch_serve_gpt.main(["--device", "cpu", "--streams", "8",
                                 "--slo-ttft-p99-ms", "1e-6"]) == 1


def test_zero_memory_report(capsys):
    res = torch_zero_memory_report.main([
        "--device", "cpu", "--hidden", "64", "--layers", "2", "--heads",
        "4"])
    out = _lines(capsys)
    assert re.fullmatch(r"model: \d\.\d{3}B params, dp=8 \(this run: 1\), "
                        r"fp32 master \+ bf16 grad sync", out[0])
    assert out[1].startswith("fp32 p+m+v total (sharded over dp): ")
    assert out[2].startswith("measured per-device (dp=1): arguments ")
    assert re.fullmatch(rf"one ZeRO step executed; loss = {FLOAT}", out[-1])
    assert res["state_bytes"] == 12 * res["state_bytes_per_shard"] * 8 / 12
    assert res["argument_bytes"] > res["state_bytes"]
    assert np.isfinite(res["loss"])


def test_every_jax_example_has_a_twin_and_none_imports_jax():
    ex = os.path.join(ROOT, "examples")
    names = sorted(f for f in os.listdir(ex) if f.endswith(".py"))
    jax_side = [f for f in names if not f.startswith("torch_")
                and f not in ("_bootstrap.py", "tpu_kernel_smoke.py")]
    assert len(jax_side) == 11
    for f in jax_side:
        assert f"torch_{f}" in names, f
    pat = re.compile(r"^\s*(import jax|from jax|import apex_tpu$|"
                     r"from apex_tpu[ .])", re.M)
    for f in names:
        if f.startswith("torch_"):
            with open(os.path.join(ex, f)) as fh:
                assert not pat.search(fh.read()), f
