"""The flagship steps the lint gate holds (`python -m apex_tpu_torch.lint`),
each built as the port's benchmarks and `chip_smoke.py` build it.

On the card (the default device) at full width:

  gpt     GPT-350M (vocab 50304, seq 1024, hidden 1024, 24 layers, 16
          heads), bf16 with bf16 logits, flash attention, FusedAdam(lr=
          1e-4, master bf16), make_tp_dp_train_step, batch 12;
  bert    BERT-Large (seq 512) bf16, flash, FusedLAMB(lr=1e-4,
          weight_decay=0.01, master bf16, the no-decay mask),
          make_tp_dp_train_step, batch 32 (the bench's batch: MLM labels
          the tokens rolled, a Bernoulli(0.15) loss mask, NSP labels);
  resnet  ResNet-50 under amp O1, FusedSGD(0.1, 0.9, 1e-4),
          ddp.make_train_step(with_state=True) (the batch norms' running
          statistics updated in place), batch 256 at 224 x 224;
  serve   the serving engine's decode and prefill steps
          (`build_flagship_engine`: GPT-350M bf16, 64 slots);
  moe     the MoE-GPT ZeRO-2 step (`build_moe_train_step`).

With `device="cpu"` the JAX package's CPU smoke sizes substitute through
the same build paths (GPT and BERT hidden 64, 2 layers, 4 heads, vocab
512, seq 64, batch 2, fp32; ResNet-18 at batch 4 x 32 x 32; the serving
and MoE builders' own CPU configurations), as `scripts/lint_step.py`
does for the JAX package.

`build(target, device)` returns a list of `Program`s: a step, its
arguments and what `lint_step` should be told beside them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import torch

from apex_tpu_torch.ops._common import resolve_device


@dataclasses.dataclass
class Program:
    """One step to lint: `step(*args)`; `lint_kw` goes to `lint_step`
    (arg_names / donate_argnums where the step carries none)."""

    name: str
    step: Callable
    args: tuple
    lint_kw: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _tokens(dev, vocab, batch, seq, seed=1):
    return torch.randint(0, vocab, (batch, seq), generator=_gen(dev, seed),
                         device=dev, dtype=torch.int32)


def gpt(dev) -> List[Program]:
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.training import (
        init_sharded_optimizer, make_tp_dp_train_step)

    if dev.type == "cuda":
        bf16 = torch.bfloat16
        model = gpt_mod.gpt_350m(vocab_size=50304, seq_len=1024,
                                 dropout=0.0, dtype=bf16, logits_dtype=bf16,
                                 use_flash_attention=True)
        opt, batch = FusedAdam(lr=1e-4, master_dtype=bf16), 12
    else:
        model = gpt_mod.GPT(gpt_mod.GPTConfig(
            vocab_size=512, seq_len=64, hidden=64, num_layers=2,
            num_heads=4, dropout=0.0))
        opt, batch = FusedAdam(lr=1e-4), 2
    c = model.c
    state = init_sharded_optimizer(opt, model, model.init(seed=0,
                                                          device=dev))
    step = make_tp_dp_train_step(model, opt, device=dev)
    tokens = _tokens(dev, c.vocab_size, batch, c.seq_len)
    return [Program("gpt", step, (state, tokens, torch.roll(tokens, -1, 1)))]


def bert(dev) -> List[Program]:
    from apex_tpu_torch.models import bert as bert_mod
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.transformer.pipeline_parallel import (
        get_params_for_weight_decay_optimization)
    from apex_tpu_torch.transformer.training import (
        init_sharded_optimizer, make_tp_dp_train_step)

    if dev.type == "cuda":
        bf16 = torch.bfloat16
        cfg = bert_mod.BertConfig(seq_len=512, dtype=bf16,
                                  use_flash_attention=True)
        master, batch = bf16, 32
    else:
        cfg = bert_mod.BertConfig(vocab_size=512, seq_len=64, hidden=64,
                                  num_layers=2, num_heads=4)
        master, batch = torch.float32, 2
    model = bert_mod.Bert(cfg)
    params = model.init(seed=0, device=dev)
    opt = FusedLAMB(lr=1e-4, weight_decay=0.01, master_dtype=master,
                    wd_mask=get_params_for_weight_decay_optimization(params))
    state = init_sharded_optimizer(opt, model, params)
    del params

    def loss_fn(p, t, lab):
        return model.loss(p, t, lab[0], lab[1], lab[2])

    step = make_tp_dp_train_step(model, opt, loss_fn=loss_fn, device=dev)
    tokens = _tokens(dev, cfg.vocab_size, batch, cfg.seq_len)
    mask = torch.rand((batch, cfg.seq_len), generator=_gen(dev, 2),
                      device=dev) < 0.15
    nsp = torch.randint(0, 2, (batch,), generator=_gen(dev, 3), device=dev,
                        dtype=torch.int32)
    labels = (torch.roll(tokens, -1, dims=1), mask, nsp)
    return [Program("bert", step, (state, tokens, labels))]


def resnet(dev) -> List[Program]:
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import resnet as rn
    from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.parallel import ddp

    if dev.type == "cuda":
        model, batch, size = rn.resnet50(), 256, 224
    else:
        model, batch, size = rn.ResNet("resnet18"), 4, 32
    params, mstate = model.init(seed=0, device=dev)
    amp_state = amp.initialize(opt_level="O1", device=dev)

    def loss_fn(p, ms, b):
        x, y = b
        logits, new_ms = model.apply(p, ms, x, training=True)
        return torch.mean(softmax_cross_entropy_loss(logits.float(), y)), \
            new_ms

    opt = FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
    state = opt.init(params)
    del params
    step = ddp.make_train_step(loss_fn, opt, amp_state=amp_state,
                               with_state=True, device=dev)
    x = torch.randn((batch, size, size, 3), generator=_gen(dev, 1),
                    device=dev)
    y = torch.randint(0, 1000, (batch,), generator=_gen(dev, 2), device=dev)
    return [Program("resnet", step,
                    (state, amp_state.loss_scalers[0], mstate, (x, y)))]


def serve(dev) -> List[Program]:
    """The decode and the prefill step of the flagship engine, slot 0
    holding a prompt of half the prompt length."""
    import numpy as np

    from apex_tpu_torch.serve import build_flagship_engine

    eng = build_flagship_engine(device=dev)
    sc = eng.serve_cfg
    n = sc.max_prompt_len // 2
    eng.cache.allocate_slot(0, n + sc.max_new_cap)
    state = eng.state._replace(block_table=eng.cache.device_table())
    prompt = np.zeros((sc.max_prompt_len,), np.int32)
    prompt[:n] = np.arange(1, n + 1) % eng.model_cfg.vocab_size
    names = {"arg_names": ("params", "kv_cache", "state"),
             "donate_argnums": (1, 2)}
    return [
        Program("serve.decode", eng._decode_fn,
                (eng.params, eng.kv, state), dict(names)),
        Program("serve.prefill", eng._prefill_fn,
                (eng.params, eng.kv, state, 0,
                 torch.tensor(prompt, device=dev), n, sc.max_new_cap),
                {"arg_names": names["arg_names"]
                 + ("slot", "tokens", "length", "req_max_new"),
                 "donate_argnums": (1, 2)})]


def moe(dev) -> List[Program]:
    from apex_tpu_torch.models.moe_gpt import build_moe_train_step

    _, step, (state, _, (shape, _)), info = build_moe_train_step(dev)
    tokens = _tokens(dev, info["config"].vocab_size, *tuple(shape))
    return [Program("moe", step,
                    (state, None, (tokens, torch.roll(tokens, -1, 1))))]


BUILDERS = {"gpt": gpt, "bert": bert, "resnet": resnet, "serve": serve,
            "moe": moe}


def build(target: str, device=None) -> List[Program]:
    """The programs of one flagship `target` on `device` (the card
    unless the caller asks for the CPU)."""
    return BUILDERS[target](resolve_device(device))


def lint_target(target: str, device=None, *, allowlist=()):
    """Build and lint one flagship.  Returns (LintReport, {program name:
    record counts})."""
    from apex_tpu_torch.lint import engine as E
    from apex_tpu_torch.lint.findings import LintReport, apply_allowlist

    findings, counts = [], {}
    for prog in build(target, device):
        rec = E.record_program(getattr(prog.step, "wrapped", prog.step),
                               prog.args)
        counts[prog.name] = rec.counts()
        findings += E.lint_step(prog.step, prog.args, program=prog.name,
                                record=rec, **prog.lint_kw)
        del rec
    new, allowed = apply_allowlist(findings, allowlist)
    return LintReport(target=target, new=new, allowlisted=allowed), counts
