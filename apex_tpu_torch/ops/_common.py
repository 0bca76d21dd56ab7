"""Shared kernel-layer plumbing (counterpart of apex_tpu/ops/_common.py).

Dispatch follows the tensor's device, with no environment switch: a
CPU tensor runs a kernel's plain PyTorch version, a CUDA tensor runs
the hand-written kernel or the call raises.  Entry points resolve their
device with `resolve_device`, which defaults to the card and refuses to
carry on without one.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for another.  Raises when CUDA is asked for (explicitly or by
    default) and absent — an entry point never slides onto the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: apex_tpu_torch entry points run "
                "on the GPU by default; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:      # "cuda" → the current card, by index
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_kernel_device(*tensors: torch.Tensor) -> bool:
    """True when the kernel must run (every tensor on one CUDA device),
    False when the plain version must (every tensor on the CPU).
    Anything else — mixed devices, another backend — raises."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(
        "kernel inputs must all lie on the CPU (plain version) or all on "
        f"one CUDA device (kernel); got {sorted(str(t.device) for t in tensors)}")


_SMS = {}


def sm_count(device) -> int:
    """The card's SM count (a persistent grid's size), asked once a
    device."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def strict_matmul_numerics() -> None:
    """The GEMM numerics the JAX package gets from
    `preferred_element_type=float32`: bf16 products reduce in fp32
    (no reduced-precision split-K reduction), and fp32 matmuls run in
    full fp32 (no TF32 — prefill attention is an fp32 einsum).  Process
    wide, as PyTorch's switches are."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def host_seed(key: torch.Generator, low: int = -2 ** 31,
              high: int = 2 ** 31 - 1) -> int:
    """One draw in [low, high) from `key` as a host int.  `key` must be a
    CPU `torch.Generator`: the draw then never waits for the card."""
    if key.device.type != "cpu":
        raise ValueError(
            f"a key whose draws reach the host must be a CPU torch.Generator, "
            f"got one on {key.device} (reading its draw would wait for the "
            "card)")
    return int(torch.randint(low, high, (1,), generator=key))


def dropout(key: Optional[torch.Generator], rate: float, x: torch.Tensor):
    """Inverted-bernoulli dropout ≡ the JAX package's `_common.dropout`:
    zero each element with probability `rate` and scale the survivors by
    1/(1-rate) (`x / (1 - rate)` in x's dtype).  With rate 0 or no key it
    returns x itself.  The mask is `rand < 1 - rate` drawn from `key`, a
    `torch.Generator`, when it lives on x's device; otherwise (a CPU key
    for a CUDA tensor) from a generator on x's device seeded with one
    host draw from `key`.  The one implementation shared by the dense
    attention reference and the models (the flash kernels' in-kernel
    mask is a coordinate hash: `ops.flash_attention.dropout_keep_dense`)."""
    if rate == 0.0 or key is None:
        return x
    keep = 1.0 - rate
    gen = key
    if key.device.type != x.device.type:
        gen = torch.Generator(device=x.device).manual_seed(
            host_seed(key, 0, 2 ** 63 - 1))
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def row_block(rows: int, hidden: int, bytes_per_elt: int = 4,
              vmem_budget: int = 2 * 1024 * 1024, align: int = 8,
              cap: int = 1024) -> int:
    """Row-block size so a (block, hidden) fp32 tile fits the budget;
    aligned to 8 rows (the JAX package's heuristic, kept for the
    kernels that tile rows)."""
    b = max(align, vmem_budget // max(1, hidden * bytes_per_elt))
    b = min(b, cap, round_up(rows, align))
    return round_up(b, align) if b % align else b
