"""Dtype-policy lint — the static form of Apex's AMP cast lists
(counterpart of apex_tpu/lint/dtype_policy.py, over the program record
of `lint.engine`).

  DP101  a GEMM (matmul, convolution, or a GEMM kernel of the port)
         with fp32 operands and no low-precision one inside a program
         whose policy is low-precision: the silent upcast that costs
         the card's bf16 tensor-core rate.  A GEMM inside a
         ``fp32_class:<name>`` range (`ops._common.fp32_class`) is
         deliberately fp32 (Apex's FP32 cast list) and exempt.
  DP102  a lossy conversion round trip (fp32 -> bf16 -> fp32 with
         nothing in between) on a tensor big enough to matter: the
         upcast is the downcast's ONLY reader (a bf16 copy that also
         feeds a GEMM is the normal mixed-precision shape).  One case is
         exempt, where the JAX rule fires: the downcast is autograd
         handing a low-precision leaf parameter its gradient in the
         parameter's dtype and shape (`Op.param_grad_cast`, which torch
         does by contract), and the upcast comes after the backward
         pass (the optimizer's fp32 gradient buffer).  The MoE router's
         bf16 weight takes its gradient so: an fp32 product, as the
         router's fp32 contract wants it, then the parameter's bf16.
  DP103  a sum or product reducing >= threshold elements whose input
         and output are both low precision: the result carries a
         low-precision accumulator's error.  `x.sum(dtype=
         torch.float32)` (or an upcast first) is the conforming form.
  DP104  master-weight update math not in fp32: a large fp32 output of
         the step (a returned tensor or an argument the step updates in
         place) whose last write is an upcast of a low-precision value
         of the same size — the update was computed low-precision and
         the fp32 buffer only stores the rounded result.
  DP105  a top-k / sort selection over LOW-PRECISION operands — the
         MoE router contract (apex_tpu_torch.moe): gate logits and
         their softmax are fp32 whatever the compute dtype.
"""

from __future__ import annotations

from typing import List

from apex_tpu_torch.lint import engine as E
from apex_tpu_torch.lint.findings import Finding, make_finding

# GEMM-class ATen ops and the positions of their operands
_GEMM_OPERANDS = {
    "mm": (0, 1), "bmm": (0, 1), "matmul": (0, 1), "dot": (0, 1),
    "addmm": (1, 2), "baddbmm": (1, 2), "addbmm": (1, 2), "addmv": (1, 2),
    "mv": (0, 1), "_addmm_activation": (1, 2),
    "convolution": (0, 1), "_convolution": (0, 1),
    "cudnn_convolution": (0, 1), "convolution_backward": (0, 1, 2),
    "_scaled_dot_product_flash_attention": (0, 1, 2),
    "_scaled_dot_product_efficient_attention": (0, 1, 2),
    "_scaled_dot_product_cudnn_attention": (0, 1, 2),
}

# the port's GEMM kernels (their launchers' names): every operand
_GEMM_KERNEL_PREFIXES = ("flash_fwd", "flash_bwd", "flash_decode",
                         "linear_bias")

# reductions whose accumulator dtype matters
_ACCUM_REDUCTIONS = ("sum", "prod", "nansum")

# selection ops the DP105 router-gate check covers
_SELECTION = ("topk", "sort", "argsort", "kthvalue", "msort")

# ops that convert a value's dtype (Op.convert_from is set on them)
_CONVERTS = ("_to_copy", "copy_")


def gemm_dtypes(op: E.Op):
    """The operand dtypes of a GEMM-class op, or None for another op."""
    if op.kind == "kernel":
        if op.name.startswith(_GEMM_KERNEL_PREFIXES):
            return [d for d in op.in_dtypes if E.is_float(d)][:3]
        return None
    if op.kind != "aten" or op.name not in _GEMM_OPERANDS:
        return None
    return [op.in_dtypes[i] for i in _GEMM_OPERANDS[op.name]
            if i < len(op.in_dtypes)]


def _infer_low_region(record) -> bool:
    """With no declared compute dtype: the program is a low-precision
    region when at least half its GEMMs run low-precision operands."""
    low = total = 0
    for op in record.ops:
        dts = gemm_dtypes(op)
        if dts is None or not any(E.is_float(d) for d in dts):
            continue
        total += 1
        if any(E.is_low_precision(d) for d in dts):
            low += 1
    return total > 0 and low * 2 >= total


def run(record, *, program: str, config: E.LintConfig) -> List[Finding]:
    findings: List[Finding] = []
    declared = config.compute_dtype
    low_region = (declared in E.LOW_PRECISION if declared is not None
                  else _infer_low_region(record))
    ops = record.ops

    for op in ops:
        loc = op.location(program)

        # ---- DP101: fp32 GEMM inside a low-precision region ----
        dts = gemm_dtypes(op) if low_region else None
        if (dts and any(d == "float32" for d in dts)
                and not any(E.is_low_precision(d) for d in dts)
                and not op.fp32_class):
            findings.append(make_finding(
                "DP101", loc,
                f"{op.name} runs float32 operands inside a "
                f"{declared or 'low-precision'} policy region (the "
                "card's bf16 tensor-core rate left on the table)",
                hint="cast the operands to the compute dtype at the call "
                     "site, or open ops._common.fp32_class(name) around "
                     "it if this GEMM is deliberately fp32-class"))

        # ---- DP102: lossy conversion round trip ----
        if op.name in _CONVERTS and op.convert_from is not None:
            src_writers = op.reads[0] if op.reads else frozenset()
            mid = ops[next(iter(src_writers))] if len(src_writers) == 1 \
                else None
            if (mid is not None and mid.name in _CONVERTS
                    and mid.convert_from is not None):
                d0, d1 = mid.convert_from, mid.out_dtypes[0]
                d2 = op.out_dtypes[0] if op.out_dtypes else None
                if (d0 == d2 == "float32" and E.is_low_precision(d1)
                        and record.readers.get(mid.index, 0) == 1
                        and mid.index not in record.final
                        and not (mid.param_grad_cast and not op.backward)
                        and E._numel(op.out_shapes[0])
                        >= config.min_roundtrip_elems):
                    findings.append(make_finding(
                        "DP102", loc,
                        f"value round-trips {d0} -> {d1} -> {d2} with no "
                        "compute in between — the mantissa is discarded "
                        "for nothing",
                        hint="drop both conversions, or keep the value in "
                             f"{d1} if the downcast was the intent"))

        # ---- DP105: low-precision top-k / sort selection ----
        if op.kind == "aten" and op.name in _SELECTION:
            sel = next((d for d in op.in_dtypes if E.is_float(d)), None)
            if E.is_low_precision(sel):
                findings.append(make_finding(
                    "DP105", loc,
                    f"{op.name} selects over {sel} operands — a router "
                    "gate softmax/selection in low precision loses ties "
                    "and the probability gaps the top-k keys on, silently "
                    "changing which experts train",
                    hint="compute the gate logits as an fp32 product "
                         "(moe.router.gate_logits) and keep the softmax "
                         "and the selection in fp32 (the "
                         "apex_tpu_torch.moe router contract)"))

        # ---- DP103: low-precision large reduction ----
        if op.kind == "aten" and op.name in _ACCUM_REDUCTIONS \
                and op.in_dtypes and op.out_dtypes:
            in_dt, out_dt = op.in_dtypes[0], op.out_dtypes[0]
            reduced = E._numel(op.in_shapes[0]) // max(
                1, E._numel(op.out_shapes[0]))
            if (E.is_low_precision(in_dt) and E.is_low_precision(out_dt)
                    and reduced >= config.reduction_threshold):
                findings.append(make_finding(
                    "DP103", loc,
                    f"{op.name} accumulates {reduced} {in_dt} elements "
                    f"into {out_dt} — error grows with the reduction size",
                    hint="accumulate in float32 (x.sum(dtype="
                         "torch.float32)) and downcast the result if "
                         "needed"))

    # ---- DP104: master update math not in fp32 ----
    # the step's outputs and in-place-updated arguments are the state
    # buffers: a large fp32 one whose last write is a bare upcast of a
    # same-size low-precision value was computed low-precision
    for i in sorted(record.final):
        op = ops[i]
        if op.name not in _CONVERTS or op.convert_from is None:
            continue
        out_dt = op.out_dtypes[0] if op.out_dtypes else None
        n = E._numel(op.out_shapes[0]) if op.out_shapes else 0
        if (out_dt == "float32" and n >= config.large_output_elems
                and E.is_low_precision(op.convert_from)
                and E._numel(op.in_shapes[0]) == n):
            findings.append(make_finding(
                "DP104", op.location(program),
                f"a {n}-element float32 state output is a bare upcast of "
                f"a {op.convert_from} value — the master-weight update "
                f"math ran in {op.convert_from}, the fp32 buffer only "
                "stores the rounded result",
                hint="compute the update in float32 (cast the grads up "
                     "BEFORE the optimizer math), the Apex master-weights "
                     "contract"))
    return findings
