"""The port's linter (apex_tpu_torch.lint) against the JAX package's, on
the CPU.

Every rule's seeded program (`apex_tpu_torch.lint.seeds`, the port's
spellings of tests/test_lint.py's seeded cases) fires a finding with the
rule id and severity of the JAX package's finding on its own case; DP103
is held to the port's own seeded bf16 reduction and the JAX catalog
(the JAX case does not fire under this jax: its `jnp.sum(..., dtype=
bf16)` stays a bf16 `reduce_sum`).  The clean variants of those cases
give no finding.  The clean `make_train_step` and
`make_tp_dp_train_step` steps lint clean; reports and
fixtures validate under either package's schema and render the same
text; and the allowlist, `analyze_step(lint=True)`, the AST pass over
the port's own source, `--selftest` and the CPU flagship gate run in
process.  The JAX package's own clean steps are held by
tests/test_lint.py.  The collective seeds run on a one-rank gloo world this file
makes once."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu import lint as jlint
from apex_tpu.lint import findings as jfindings
from apex_tpu_torch import lint
from apex_tpu_torch.lint import __main__ as cli
from apex_tpu_torch.lint import engine as E
from apex_tpu_torch.lint import seeds
from apex_tpu_torch.ops import _common
from apex_tpu_torch.parallel import mesh as M

SDS = jax.ShapeDtypeStruct
F32, BF16 = jnp.float32, jnp.bfloat16


@pytest.fixture(scope="module", autouse=True)
def world():
    """One one-rank gloo world (and the default mesh) for the file."""
    with seeds.one_rank_world("cpu"):
        yield


def rules_of(findings):
    return sorted(f.rule for f in findings)


# ------------------------- the JAX package's cases -------------------------

def _j(fn, args, **kw):
    return jlint.lint_program(fn, args, **kw)


def _jax_dp101():
    def f(x32, xbf, w):
        return (xbf @ w).astype(F32).sum() + (x32 @ x32.T).sum()
    return _j(f, (SDS((64, 64), F32), SDS((64, 64), BF16),
                  SDS((64, 64), BF16)))


def _jax_dp102():
    return _j(lambda x: x.astype(BF16).astype(F32) + 1.0,
              (SDS((128, 128), F32),))


def _jax_dp104():
    def f(p, g):
        return (p.astype(BF16) - 0.1 * g).astype(F32)
    return _j(f, (SDS((1 << 15,), F32), SDS((1 << 15,), BF16)))


def _jax_dp105():
    def f(x, wg):
        g, _ = jax.lax.top_k(jax.nn.softmax(jnp.dot(x, wg), axis=-1), 2)
        return g.sum()
    return _j(f, (SDS((64, 32), BF16), SDS((32, 8), BF16)))


def _axis(fn, shape=(8,), dtype=F32, env=(("i", 2),), **kw):
    return _j(fn, (SDS(shape, dtype),), axis_env=list(env), **kw)


def _jax_cl203():
    def f(w, xs):
        def body(c, t):
            return c + jax.lax.psum(w, "i").sum() + t.sum(), ()
        return jax.lax.scan(body, jnp.zeros(()), xs)[0]
    return _j(f, (SDS((8,), F32), SDS((4, 8), F32)), axis_env=[("i", 2)])


def _jax_step(donate):
    def step(state, batch):
        return jax.tree_util.tree_map(lambda a: a * 0.5, state), batch.sum()
    step.arg_names = ("opt_state", "batch")
    step.donate_argnums = (0,) if donate else ()
    return step, ({"w": SDS((128, 128), F32), "m": SDS((128, 128), F32)},
                  SDS((4, 128), F32))


def _jax_dn301():
    step, args = _jax_step(False)
    return jlint.lint_step(step, args)


def _jax_dn302():
    step, args = _jax_step(True)
    return jlint.lint_step(step, args, compile_report={
        "donation_ok": False, "undonated_bytes": 1, "donated_bytes": 2})


_JAX_SRC = '''
import jax
import numpy as np

@jax.jit
def step(x, y):
    if x > 0:
        z = float(y)
    v = x.item()
    a = np.asarray(y)
    return x

def make(n):
    lr = 0.0

    @jax.jit
    def update(p):
        return p - lr * p

    out = None
    for i in range(n):
        lr = 0.1 * i
        f = jax.jit(lambda q: q)
        out = update(out)
    return out
'''

JAX_CASES = {
    "DP101": _jax_dp101, "DP102": _jax_dp102, "DP104": _jax_dp104,
    "DP105": _jax_dp105,
    "CL201": lambda: _axis(lambda x: jax.lax.psum(x, "i"),
                           config=jlint.LintConfig(expected_axes=("dp",))),
    "CL202": lambda: _axis(lambda x: jax.lax.psum(jax.lax.psum(x, "i"),
                                                  "i")),
    "CL203": _jax_cl203,
    "CL204": lambda: _axis(lambda x: jax.lax.psum(x, "i"), dtype=jnp.float16),
    "CL205": lambda: _axis(lambda x: (jax.lax.psum(x, "i"), x * 2.0)[1]),
    "CL206": lambda: _axis(
        lambda x: jax.lax.all_to_all(x, "zz", 0, 1, tiled=True),
        shape=(8, 8), env=(("zz", 2),),
        config=jlint.LintConfig(expected_axes=("dp", "ep"))),
    "CL207": lambda: _axis(
        lambda x: jax.lax.ppermute(x, "tp", [(i, i + 1) for i in range(3)]),
        env=(("tp", 4),)),
    "DN301": _jax_dn301, "DN302": _jax_dn302,
    **{r: (lambda r=r: jlint.lint_source_text(_JAX_SRC, "s.py"))
       for r in ("HS401", "HS402", "HS403", "HS404", "HS405", "HS406")},
}


@pytest.mark.parametrize("rule", sorted(seeds.SEEDS))
def test_each_rule_fires_as_in_the_jax_package(rule):
    """The port's seeded program fires `rule` with the JAX package's rule
    id and severity on its own case (DP103: the JAX catalog's)."""
    got = {(f.rule, f.severity) for f in seeds.fire(rule, "cpu")}
    if rule == "DP103":
        want = {(rule, jfindings.RULES[rule][0])}
    else:
        want = {(f.rule, f.severity) for f in JAX_CASES[rule]()
                if f.rule == rule}
    assert want and got == want
    assert lint.RULES[rule][0] == jfindings.RULES[rule][0]


def test_the_catalogs_carry_the_same_rules():
    assert set(lint.RULES) == set(jfindings.RULES)
    assert {k: v[0] for k, v in lint.RULES.items()} == {
        k: v[0] for k, v in jfindings.RULES.items()}
    assert lint.SEVERITIES == jfindings.SEVERITIES
    assert lint.LINT_SCHEMA_VERSION == jfindings.LINT_SCHEMA_VERSION
    # the JAX package's exports, under the same names
    assert {n for n in dir(jlint) if not n.startswith("_")} <= set(dir(lint))


# ------------------------- clean variants -------------------------

def _t(*shape, dtype=torch.float32):
    return torch.randn(shape, generator=torch.Generator().manual_seed(0)
                       ).to(dtype)


def _dp_group():
    return M.group_of(M.DP_AXIS)


def _carry_loop(w, xs):
    c = torch.zeros(())
    for i in range(xs.shape[0]):
        with _common.loop_iteration("body", i):
            c = c + M.all_reduce(xs[i].clone(), "sum", _dp_group()).sum()
    return c


class _Fp32Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x)
        return x @ w.float()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return None, (x.t() @ g).to(torch.bfloat16)


def _grad_then_upcast(x, w):
    w = w.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(_Fp32Grad.apply(x, w).sum(), [w])
    return g.float()


class _Fp32GradIn(torch.autograd.Function):
    """x @ w in fp32 whose backward hands x's gradient back in x's
    bf16."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(w)
        return x.float() @ w

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return (g @ w.t()).to(torch.bfloat16), None


def _activation_grad_then_upcast(x, w):
    h = x.detach().requires_grad_(True) * 2.0
    (g,) = torch.autograd.grad(_Fp32GradIn.apply(h, w).sum(), [h])
    return g.float()


def test_dp102_exempts_a_parameter_gradient_only():
    """DP102's one exemption, against the JAX rule's verdict: on the
    equivalent program (a bf16 parameter's fp32 gradient, which
    `jax.grad` rounds to bf16, then upcast as an fp32 gradient sync) the
    JAX package fires DP102, where the port takes the rounding as
    autograd's contract (`dp102_gradient` among the clean cases).
    Where the downcast is not a parameter's gradient the port fires as
    the JAX rule does: a round trip of a gradient-sized tensor in the
    forward pass, and an activation's gradient rounded in the backward
    pass and upcast after it."""
    def jf(x, w):
        return jax.grad(lambda w: (x @ w.astype(F32)).sum())(w).astype(F32)

    jax_fs = _j(jf, (SDS((64, 128), F32), SDS((128, 64), BF16)))
    assert rules_of(jax_fs) == ["DP102"]
    fn, args = CLEAN["dp102_gradient"]
    assert lint.lint_program(fn, args) == []
    fwd = lint.lint_program(lambda x, w: x @ w.bfloat16().float(),
                            (_t(64, 128), _t(128, 64)))
    act = lint.lint_program(_activation_grad_then_upcast,
                            (_t(64, 128, dtype=torch.bfloat16), _t(128, 64)))
    for fs in (fwd, act):
        assert rules_of(fs) == ["DP102"]
        assert fs[0].severity == jax_fs[0].severity


CLEAN = {
    # a GEMM population in fp32 is no low-precision region
    "dp101_fp32_program": (lambda x, w: (x @ w).sum(), (_t(64, 64),
                                                        _t(64, 64))),
    # a GEMM that is deliberately fp32 (fp32_class) inside a bf16 program
    "dp101_fp32_class": (
        lambda x32, xbf, w: (xbf @ w).float().sum() + _fp32_gemm(x32),
        (_t(64, 64), _t(64, 64, dtype=torch.bfloat16),
         _t(64, 64, dtype=torch.bfloat16))),
    # per-channel vectors under the round-trip size floor
    "dp102_small": (lambda x: x.bfloat16().float() + 1.0, (_t(64),)),
    # a bf16 copy that also feeds a GEMM is the mixed-precision shape
    "dp102_two_readers": (
        lambda x, w: (lambda b: b.float() + (b @ w).float())(x.bfloat16()),
        (_t(128, 128), _t(128, 128, dtype=torch.bfloat16))),
    # a bf16 leaf's gradient, computed in fp32 and rounded to the leaf's
    # dtype by autograd's contract, then upcast for an fp32 sync
    "dp102_gradient": (_grad_then_upcast, (_t(64, 128),
                                           _t(128, 64, dtype=torch.bfloat16))),
    "dp103_fp32_accumulation": (
        lambda x: x.sum(dtype=torch.float32) + x.float().sum(),
        (_t(1 << 18, dtype=torch.bfloat16),)),
    "dp104_fp32_update": (lambda p, g: p.sub_(0.1 * g.float()),
                          (_t(1 << 15), _t(1 << 15, dtype=torch.bfloat16))),
    "dp105_fp32_router": (
        lambda x, wg: __import__("apex_tpu_torch.moe.router", fromlist=["x"])
        .topk_gates_dense(x, wg, 2).gate.sum(),
        (_t(64, 32, dtype=torch.bfloat16), _t(32, 8, dtype=torch.bfloat16))),
    "cl201_mesh_group": (
        lambda x: M.all_reduce(x.clone(), "sum", _dp_group()), (_t(8),)),
    "cl203_carry_dependent": (_carry_loop, (_t(8), _t(4, 8))),
    "cl204_bf16": (lambda x: M.all_reduce(x.clone(), "sum", _dp_group()),
                   (_t(8, dtype=torch.bfloat16),)),
    "cl204_fp16_max": (lambda x: M.all_reduce(x.clone(), "max", _dp_group()),
                       (_t(8, dtype=torch.float16),)),
    "cl207_rings": (
        lambda x: (__import__("apex_tpu_torch.parallel.collectives",
                              fromlist=["x"]).ring_exchange(x, "tp", -1),
                   __import__("apex_tpu_torch.parallel.collectives",
                              fromlist=["x"]).halo_exchange_1d(x, "tp", 1)),
        (_t(8, 4),)),
}


def _fp32_gemm(x32):
    with _common.fp32_class("deliberate"):
        return (x32 @ x32.T).sum()


@pytest.mark.parametrize("case", sorted(CLEAN))
def test_clean_variants_give_no_finding(case):
    fn, args = CLEAN[case]
    assert lint.lint_program(fn, args) == []


def test_hostsync_fresh_def_per_iteration_and_inline_disable():
    """A def inside the rebinding loop is a fresh function per iteration;
    an inline `# lint: disable=RULE` drops its line's finding."""
    fresh = '''
import torch
from apex_tpu_torch.ops._common import device_step

def sweep(n):
    for i in range(n):
        s = i + 1

        @device_step
        def f(x):
            return x * s
        f(torch.ones(2))
'''
    assert lint.lint_source_text(fresh, "sweep.py") == []
    src = '''
import torch

def sweep(xs):
    for x in xs:
        f = torch.compile(lambda q: q * x)  # lint: disable=HS405
        f(x)
'''
    assert lint.lint_source_text(src, "s.py") == []
    assert rules_of(lint.lint_source_text(
        src.replace("  # lint: disable=HS405", ""), "s.py")) == ["HS405"]


# ------------------------- the record -------------------------

def test_the_record_holds_kernels_loops_and_backward():
    """A launcher's `note_launch` is a kernel op of the record (a bf16
    GEMM kernel counts toward the low-precision region); a loop's
    iterations share one location and restart their ordinals; backward
    ops are recorded."""
    def f(q, w):
        _common.note_launch("flash_fwd_cuda", q, q, q)
        y = (w * 2.0).sum()
        for i in range(3):
            with _common.loop_iteration("hop", i):
                y = y + w.sum()
        (g,) = torch.autograd.grad(y, [w])
        return g + (w.float() @ w.float().T).sum()

    w = _t(16, 16, dtype=torch.bfloat16).requires_grad_(True)
    rec = lint.record_program(f, (_t(2, 4, 16, 64, dtype=torch.bfloat16), w))
    counts = rec.counts()
    assert counts["kernels"] == {"flash_fwd_cuda": 1}
    assert counts["collectives"] == 0 and counts["ops"] > 5
    loop_sums = [op for op in rec.ops if op.path == "hop" and op.name == "sum"]
    assert len(loop_sums) == 3 and {op.ordinal for op in loop_sums} == {0}
    assert len({op.loops[-1][0] for op in loop_sums}) == 1
    assert any(op.backward for op in rec.ops)
    fs = lint.lint_program(record=rec, program="rec")
    assert rules_of(fs) == ["DP101"] and fs[0].location == "rec::mm[0]"


def test_a_sentry_wrapped_step_lints_without_counting(monkeypatch):
    from apex_tpu_torch.monitor.compile import RecompileSentry

    step, args = seeds._small_step(torch.device("cpu"))
    sentry = RecompileSentry(step, warn=False)
    for name in ("arg_names", "donate_argnums", "mesh_axis_names"):
        setattr(sentry, name, getattr(step, name))
    assert sentry.wrapped is step
    assert lint.lint_step(sentry, args) == []
    assert sentry.calls == 0 and sentry.n_signatures == 0


def test_a_donated_model_state_is_updated_in_place():
    """DN301 reads the model state too: a with_state step donates it
    (the new statistics written into the given tensors, which the step
    returns), and a step that did not would keep a second copy."""
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.parallel import ddp

    def loss_fn(p, ms, b):
        h = b @ p["w"]
        new = {"mean": 0.9 * ms["mean"] + 0.1 * h.mean(0)}
        return (h ** 2).mean(), new

    opt = FusedSGD(lr=0.1)
    state = opt.init({"w": _t(8, 1 << 15)})
    ms = {"mean": torch.zeros(1 << 15)}           # 128 KiB of state
    args = (state, None, ms, _t(4, 8))
    step = ddp.make_train_step(loss_fn, opt, with_state=True, device="cpu")
    assert step.donate_argnums == (0, 2)
    assert lint.lint_step(step, args) == []
    fs = lint.lint_step(step, args, donate_argnums=(0,))
    assert rules_of(fs) == ["DN301"] and "model_state" in fs[0].location
    want = 0.1 * (args[3] @ state.params[:8 << 15].view(8, 1 << 15)).mean(0)
    out = step(*args)
    assert out[2] is ms
    torch.testing.assert_close(ms["mean"], want)

    def renamed(p, ms, b):
        return loss_fn(p, ms, b)[0], {"avg": ms["mean"]}

    bad = ddp.make_train_step(renamed, opt, with_state=True, device="cpu")
    with pytest.raises(ValueError, match="writes one into the other"):
        bad(*args)


# ------------------------- clean steps, both packages -------------------------

CFG = dict(vocab_size=512, seq_len=64, hidden=64, num_layers=2, num_heads=4,
           dropout=0.0)


def _port_clean(kind):
    from apex_tpu_torch.models.gpt import GPT, GPTConfig
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import ddp
    from apex_tpu_torch.transformer import training

    model = GPT(GPTConfig(**CFG))
    opt = FusedAdam(lr=1e-3)
    state = training.init_sharded_optimizer(opt, model,
                                            model.init(seed=0, device="cpu"))
    tok = torch.randint(0, 512, (2, 64), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1))
    if kind == "ddp":
        step = ddp.make_train_step(lambda p, b: model.loss(p, b[0], b[1]),
                                   opt, device="cpu")
        args = (state, None, (tok, tok))
    else:
        step = training.make_tp_dp_train_step(model, opt, device="cpu")
        args = (state, tok, tok)
    assert "dp" in step.mesh_axis_names
    return lint.lint_step(step, args)


@pytest.mark.parametrize("kind", ["ddp", "tp_dp"])
def test_clean_steps_lint_clean_in_both_packages(kind):
    """The real data-parallel and tensor/data-parallel steps (GPT, 2
    layers, FusedAdam, on the one-rank world, whose dp all-reduces of
    the grads and the loss the record holds) have no finding, as the
    JAX package's same steps have none
    (tests/test_lint.py::test_clean_ddp_train_step and
    ::test_clean_tp_dp_train_step)."""
    assert _port_clean(kind) == []


# ------------------------- reports, allowlist, gate -------------------------

def test_reports_cross_validate_and_render_alike():
    f = lint.make_finding("CL204", "p::all_reduce[0]", "msg", hint="h")
    rep = lint.LintReport(target="t", new=[f], allowlisted=[])
    d = json.loads(json.dumps(rep.to_dict()))
    jlint.validate_findings(d)
    lint.validate_findings(d)
    assert lint.render_findings(d) == jlint.render_findings(d)
    jf = jlint.make_finding("HS401", "x.py:3", "m")
    jd = json.loads(json.dumps(jlint.LintReport(
        target="j", new=[], allowlisted=[jf]).to_dict()))
    lint.validate_findings(jd)
    assert lint.render_findings(jd) == jlint.render_findings(jd)
    for obj, _ in ((json.load(open(cli.FIXTURE)), "port"),
                   (json.load(open(cli.FIXTURE.replace(
                       "apex_tpu_torch/lint/fixture.json",
                       "scripts/lint_fixture.json"))), "jax")):
        lint.validate_findings(obj)
        jlint.validate_findings(obj)
    with pytest.raises(ValueError, match="lint_schema_version"):
        lint.validate_findings(dict(d, lint_schema_version=999))
    with pytest.raises(ValueError, match="ok bit"):
        lint.validate_findings(dict(d, ok=True))
    with pytest.raises(ValueError, match="unknown lint rule"):
        lint.Finding(rule="ZZ000", severity="error", location="x",
                     message="m")


def test_allowlist_parse_apply_glob_and_the_committed_one_is_empty():
    entries = lint.parse_allowlist("# comment\nHS401 examples/*.py:*\n"
                                   "DP101\n")
    a = lint.make_finding("HS401", "examples/foo.py:12", "m")
    b = lint.make_finding("HS401", "scripts/foo.py:12", "m")
    c = lint.make_finding("DP101", "anywhere::mm[0]", "m")
    new, allowed = lint.apply_allowlist([a, b, c], entries)
    assert [f.location for f in new] == ["scripts/foo.py:12"]
    assert len(allowed) == 2
    with pytest.raises(ValueError, match="unknown rule"):
        lint.parse_allowlist("XX999 foo\n")
    assert lint.load_allowlist(cli.ALLOWLIST) == []


def test_analyze_step_attaches_the_lint_of_the_same_run():
    from apex_tpu_torch import monitor

    step, args = seeds._small_step(torch.device("cpu"))
    rep = monitor.analyze_step(step, args, lint=True)
    assert rep.lint == {"ok": True, "findings": []}
    assert rep.to_dict()["lint"]["ok"] is True
    assert "lint: clean" in monitor.render_budget_table(rep)
    assert monitor.analyze_step(step, args).lint is None
    # the cross-check reads this report: a donation it saw fail is DN302
    # (and the state left out of the donated arguments DN301)
    bad = monitor.analyze_step(step, args, donated=(2,), lint=True)
    assert bad.donation_ok is False
    assert sorted(f["rule"] for f in bad.lint["findings"]) == ["DN301",
                                                               "DN302"]


def test_the_port_source_passes_the_ast_gate():
    """The AST pass over the port's package, the chip script and the
    port's examples, with the committed (empty) allowlist."""
    fs = lint.lint_paths(cli.ast_trees(), root=cli._ROOT)
    assert fs == [], [f"{f.rule} {f.location}" for f in fs]
    assert any(p.endswith("apex_tpu_torch") for p in cli.ast_trees())


def test_selftest_and_seeds_gates(capsys):
    assert cli.main(["--selftest"]) == 0
    assert "lint --selftest: OK" in capsys.readouterr().out


def test_cpu_flagship_gate_is_clean(capsys):
    """`python -m apex_tpu_torch.lint ... --device cpu`: the five
    flagships at the CPU smoke sizes clean against the empty allowlist
    (the AST target: the test above)."""
    rc = cli.main(["gpt", "bert", "resnet", "serve", "moe",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "5 target(s), CLEAN" in out
    assert dist.is_initialized()        # the file's world is still up
