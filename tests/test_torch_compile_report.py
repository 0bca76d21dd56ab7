"""The port's step audit (apex_tpu_torch.monitor.compile.analyze_step,
`render_budget_table`) against the JAX package's, on the CPU, over a GPT
of 2 layers at hidden 64 (seq 128, vocab 128, batch 2).

  * the caller's state after `analyze_step` is bit for bit a twin's
    (the audit runs on clones and restores the global RNG), and a step
    from each gives the same bits;
  * the budget's params bytes equal the JAX `tree_bytes` of the JAX
    optimizer's master buffer for the same parameters (both flat
    layouts pad alike), its optimizer state the rest of that state;
  * the counted flops of the step agree with `gpt_step_flops` within
    `flops_tol` (10%); on the card's route (the flash kernels' wrappers
    and launchers, with the CUDA library stood in by one that zero-fills
    their outputs: a hand-written kernel, which no flop counter sees)
    the launchers' own counts make up the attention and the total is the
    plain route's, exactly; with those counts left out the same step
    fails the check;
  * `render_budget_table` renders the same text as the JAX package's for
    the same report dict, with and without the attachments;
  * the flight recorder's report renders the attached budget table.
"""

import ctypes

import jax
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPT as JGPT
from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.monitor.compile import report as jreport
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu_torch import monitor
from apex_tpu_torch.models import gpt as gpt_mod
from apex_tpu_torch.monitor import flops as flops_lib
from apex_tpu_torch.monitor.compile import report as creport
from apex_tpu_torch.ops import flash_attention as tfa
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import ddp
from apex_tpu_torch.transformer.training import init_sharded_optimizer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny ops run faster on one thread than spread over a shared
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dict(vocab_size=128, seq_len=128, hidden=64, num_layers=2)
BATCH = 2


def _gpt(num_heads=4, **kw):
    """The model, its JAX twin's seed-0 weights loaded, the optimizer
    state, the data-parallel step and a seeded batch."""
    jm = JGPT(JGPTConfig(**CFG, num_heads=num_heads))
    jp = jm.init(jax.random.PRNGKey(0))
    model = gpt_mod.GPT(gpt_mod.GPTConfig(**CFG, num_heads=num_heads,
                                          dropout=0.0, **kw))
    params = gpt_mod.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     device="cpu",
                                     dtype=kw.get("dtype", torch.float32))
    opt = FusedAdam(lr=1e-3)
    state = init_sharded_optimizer(opt, model, params)
    step = ddp.make_train_step(lambda p, b: model.loss(p, b[0], b[1]), opt,
                               device="cpu")
    g = torch.Generator().manual_seed(7)
    tok = torch.randint(0, CFG["vocab_size"], (BATCH, CFG["seq_len"]),
                        generator=g, dtype=torch.int32)
    return model, jp, state, step, (tok, torch.roll(tok, -1, 1))


def _copy(state):
    return type(state)(*[x.clone() for x in state])


def test_audit_leaves_the_state_bit_for_bit():
    model, _, state, step, batch = _gpt()
    twin = _copy(state)
    torch.manual_seed(11)
    rep = monitor.analyze_step(step, (state, None, batch))
    draw = torch.rand(4)
    torch.manual_seed(11)
    assert torch.equal(draw, torch.rand(4)), "the global RNG moved"
    assert all(torch.equal(a, b) for a, b in zip(state, twin))
    a = step(state, None, batch)
    b = step(twin, None, batch)
    assert torch.equal(a[2], b[2])
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    # the step's labels and the in-place update
    assert step.arg_names == ("opt_state", "scaler_state", "batch")
    assert step.donate_argnums == (0,)
    assert (step.mesh_axis_names, step.mesh_axis_sizes) == (("dp",), (1,))
    assert rep.donation_ok is True
    assert rep.undonated_bytes == 4          # the int32 step counter
    assert rep.alias_bytes == rep.donated_bytes - 4
    assert rep.backend == "cpu" and rep.temp_bytes is None
    assert rep.generated_code_bytes is None and rep.bytes_accessed is None
    assert rep.lint is None and rep.comms is None


def test_budget_bytes_equal_jax_tree_bytes():
    _, jp, state, step, batch = _gpt()
    js = JFusedAdam(lr=1e-3).init(jp)
    rep = monitor.analyze_step(step, (state, None, batch))
    assert rep.budget["params"] == jreport.tree_bytes(js.params)
    assert rep.budget["optimizer_state"] == (
        jreport.tree_bytes(js) - jreport.tree_bytes(js.params))
    assert rep.budget["inputs"] == jreport.tree_bytes(
        tuple(np.asarray(t) for t in batch))
    assert rep.arg_bytes["opt_state"] == jreport.tree_bytes(js)
    assert creport.tree_bytes(state) == jreport.tree_bytes(js)


def test_counted_flops_agree_with_the_accounting():
    model, _, state, step, batch = _gpt()
    fps = flops_lib.gpt_step_flops(model.c, BATCH)
    rep = monitor.analyze_step(step, (state, None, batch),
                               analytic_flops=fps)
    assert rep.flops_ok is True and rep.flops_divergence <= 0.10
    assert rep.analytic_flops == fps


class _ZeroLib:
    """The flash library stood in: each launcher zero-fills the outputs
    its C function would write (o and lse forward; dk and dv backward,
    whose dq scratch starts zeroed) and returns 0, a launch."""

    def apex_flash_attn_fwd(self, d, q, k, v, o, lse, strides, b, h, sq,
                            sk, *rest):
        ctypes.memset(o, 0, b * h * sq * d * 2)
        ctypes.memset(lse, 0, b * h * sq * 4)
        return 0

    def apex_flash_attn_bwd(self, d, q, k, v, do, lse, delta, dq, dk, dv,
                            work, strides, b, h, sq, sk, scale, causal,
                            f32, *rest):
        for p in (dk, dv):
            ctypes.memset(p, 0, b * h * sk * d * (4 if f32 else 2))
        return 0


def _card_route(monkeypatch):
    """GPT's flash attention on CPU tensors takes the card's route: the
    dispatch, `_FlashFn` and the real launchers, with the library, the
    device check and the stream stood in."""
    monkeypatch.setattr(tfa, "check_kernel_device", lambda *t: True)
    monkeypatch.setattr(tfa, "_require_cuda", lambda *t: None)
    monkeypatch.setattr(tfa, "_tuned_flash_config", lambda *a: None)
    monkeypatch.setattr(tfa.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(tfa, "_LIB", _ZeroLib())


def test_kernel_flops_counted_once_on_either_route(monkeypatch):
    """Head dim 64 (one head), bf16: the flash kernels' shape.  The
    plain route's attention is ATen einsums the flop counter sees; the
    card's is the launchers' `add_kernel_flops`; both totals are the
    accounting's; without the launchers' counts the check fails."""
    kw = dict(num_heads=1, dtype=torch.bfloat16, use_flash_attention=True)
    model, _, state, step, batch = _gpt(**kw)
    fps = flops_lib.gpt_step_flops(model.c, BATCH)
    plain = monitor.analyze_step(step, (state, None, batch),
                                 analytic_flops=fps)
    assert plain.flops_ok is True
    launches = tfa.flash_fwd_cuda.launches, tfa.flash_bwd_cuda.launches
    _card_route(monkeypatch)
    card = monitor.analyze_step(step, (state, None, batch),
                                analytic_flops=fps)
    assert (tfa.flash_fwd_cuda.launches - launches[0],
            tfa.flash_bwd_cuda.launches - launches[1]) == (2, 2)
    assert card.flops == plain.flops and card.flops_ok is True
    monkeypatch.setattr(tfa, "add_kernel_flops", lambda n: None)
    left_out = monitor.analyze_step(step, (state, None, batch),
                                    analytic_flops=fps)
    attention = 2 * 3 * 4 * BATCH * CFG["seq_len"] ** 2 * CFG["hidden"]
    assert card.flops - left_out.flops == attention
    assert left_out.flops_ok is False
    assert "FLOPS ACCOUNTING DIVERGES" in monitor.render_budget_table(
        left_out)
    tfa.flash_fwd_cuda.launches, tfa.flash_bwd_cuda.launches = launches


def _variants(d):
    """The report dict and its variants the table renders differently."""
    return [d,
            dict(d, donation_ok=False, undonated_bytes=3 << 20,
                 donated_bytes=12 << 20),
            dict(d, flops_ok=False, flops=2.5e9, analytic_flops=1.0e9,
                 flops_divergence=1.5),
            dict(d, budget=dict(d["budget"], kv_cache=5 << 30,
                                activations_temps=7 << 20)),
            dict(d, lint={"ok": False, "findings": [{"rule": "DN301"}]}),
            dict(d, comms={"collectives": [], "counts": {"all-reduce": 2},
                           "total_comm_bytes": 1 << 20, "overlap_ok": True,
                           "async_supported": False}),
            dict(d, comms={"ok": None, "error": "boom"})]


@pytest.mark.parametrize("i", range(7))
def test_budget_table_renders_as_jax(i):
    _, _, state, step, batch = _gpt()
    rep = monitor.analyze_step(step, (state, None, batch),
                               analytic_flops=1.0e8)
    d = _variants(rep.to_dict())[i]
    assert monitor.render_budget_table(d) == jreport.render_budget_table(d)


def test_lint_is_not_ported_and_comms_attaches():
    _, _, state, step, batch = _gpt()
    with pytest.raises(NotImplementedError, match="item 26"):
        monitor.analyze_step(step, (state, None, batch), lint=True)
    rep = monitor.analyze_step(step, (state, None, batch), comms=True)
    monitor.comms.validate_comms_report(rep.comms)
    assert rep.comms["collectives"] == []          # a world of one
    assert rep.comms["compute_s"] == pytest.approx(
        rep.flops / flops_lib.device_peak_flops("cpu"))
    assert "comms: 0 collective(s)" in monitor.render_budget_table(rep)


def test_flight_report_renders_the_budget_table(tmp_path):
    from apex_tpu_torch.monitor.trace import report as trace_report

    _, _, state, step, batch = _gpt()
    rep = monitor.analyze_step(step, (state, None, batch))
    rec = monitor.FlightRecorder(str(tmp_path / "flight.json"))
    rec.attach_compile_report(rep)
    text = trace_report.render_report(rec.report("oom", oom=True))
    assert "=== HBM budget ===" in text
    assert "params (master)" in text and "donation: ok" in text
