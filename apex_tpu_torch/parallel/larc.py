"""LARC — layer-wise adaptive rate control (counterpart of
apex_tpu/parallel/larc.py, itself ≡ apex.parallel.LARC,
apex/parallel/LARC.py).

A wrapper around an inner optimizer: before each step every parameter
tensor's gradient, with the weight decay folded in, is scaled by

    local_lr = trust_coefficient · ‖p‖ / (‖g‖ + wd · ‖p‖ + eps)

(1 where either norm is 0), divided by the base lr and clipped at 1 in
`clip` mode; the inner optimizer then steps with its weight decay set
to 0 for that step.  The per-tensor norms of p and g come from two
launches of the per-tensor sums-of-squares kernel over lane-aligned
fp32 copies of the two (`per_tensor_l2norm_aligned`).

`step_flat(state, g_flat, ...)` is the form the port's train steps
call: the grads arrive in the inner optimizer's flat layout, and the
per-tensor scale is expanded over that layout with no host sync;
`step(state, grads)` flattens a grad tree into it.  It unscales the
grads by `inv_scale` before the norms and hands the inner optimizer an
`inv_scale` of 1, so the trust ratio and the folded weight decay see
the gradient apex's LARC sees (amp unscales before the optimizer
steps).  The JAX package's LARC takes the norms of the still scaled
grads instead; without a loss scale the two agree.  `larc_adjust_grads`
is the same adjustment on a grad tree, leaf by leaf, as the JAX
package's.
"""

from __future__ import annotations

import functools

import torch

from apex_tpu_torch.ops import optimizer_kernels as K
from apex_tpu_torch.optimizers import flat as F


def _local_scale(pn, gn, lr, trust_coefficient, clip, eps, weight_decay):
    """The per-tensor factor on the (weight-decayed) grads."""
    local_lr = trust_coefficient * pn / (gn + weight_decay * pn + eps)
    # skip the adaptation where either norm is 0 (LARC.py:92-96)
    local_lr = torch.where((pn > 0) & (gn > 0), local_lr, 1.0)
    if clip:
        return torch.clamp_max(local_lr / lr, 1.0)
    return local_lr / lr       # eta mode: the step is base lr x local lr


def larc_adjust_grads(params, grads, lr, *, trust_coefficient=0.02,
                      clip=True, eps=1e-8, weight_decay=0.0):
    """LARC-adjusted grads of a grad tree (the params' structure), each
    leaf (g + wd · p) · scale[tensor] in the leaf's dtype.  The norms
    come from one kernel pass each over lane-aligned fp32 flat copies of
    params and grads."""
    spec = F.make_spec(params, align=K._LANES)

    def norms(tree):
        flat = F.flatten(tree, torch.float32, align=K._LANES,
                         pad_to=K.FLAT_TILE)
        return K.per_tensor_l2norm_aligned(flat, spec)

    scale = _local_scale(norms(params), norms(grads), lr, trust_coefficient,
                         clip, eps, weight_decay)
    out = []
    for i, (p, g) in enumerate(zip(F.tree_leaves(params),
                                   F.tree_leaves(grads))):
        g32 = g.float() + weight_decay * p.float()
        out.append((g32 * scale[i]).to(g.dtype))
    return F.tree_from_leaves(spec, out)


@functools.lru_cache(maxsize=4)
def _aligned_spec(spec: F.FlatSpec) -> F.FlatSpec:
    """`spec`'s tensors laid out lane-aligned (the norm kernel's layout)."""
    offsets, off = [], 0
    for s in spec.sizes:
        offsets.append(off)
        off += -(-s // K._LANES) * K._LANES
    return F.FlatSpec(paths=spec.paths, shapes=spec.shapes,
                      dtypes=spec.dtypes, sizes=spec.sizes,
                      offsets=tuple(offsets), total=off, align=K._LANES)


class LARC:
    """Optimizer wrapper ≡ apex.parallel.LARC:
    larc = LARC(FusedSGD(lr=...)); state = larc.init(params);
    params, state = larc.step(state, grads)."""

    def __init__(self, optimizer, trust_coefficient=0.02, clip=True,
                 eps=1e-8):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps

    @property
    def spec(self):
        return self.optim.spec

    def init(self, params):
        return self.optim.init(params)

    def step(self, state, grads, lr=None, **kw):
        """One step from a grad tree: flattened in the inner optimizer's
        layout, then `step_flat` (`kw`: inv_scale, found_inf)."""
        spec = self.optim.spec
        if spec is None:
            raise RuntimeError("call init(params) before step()")
        gdts = {g.dtype for g in F.tree_leaves(grads)}
        gdt = gdts.pop() if len(gdts) == 1 else torch.float32
        return self.step_flat(state, F.flatten(
            grads, gdt, pad_to=state.params.numel(), align=spec.align),
            lr=lr, **kw)

    def step_flat(self, state, g_flat, lr=None, inv_scale=1.0,
                  found_inf=False):
        """One step from a flat grad buffer in the inner optimizer's
        layout (the port's train steps call this).  The grads are
        unscaled here; an overflow (`found_inf`) is handed on, and the
        inner step keeps its state."""
        spec = self.optim.spec
        if spec is None:
            raise RuntimeError("call init(params) before step_flat()")
        dev = state.params.device
        lr_val = lr if lr is not None else self.optim.lr
        wd = getattr(self.optim, "weight_decay", 0.0)
        g32 = g_flat.float() * K.device_scalar(inv_scale, torch.float32, dev)
        aligned = _aligned_spec(spec)

        def norms(flat):
            leaves = F.unflatten_leaves(flat, spec, cast_to_leaf_dtype=False)
            return K.per_tensor_l2norm_aligned(
                F.flatten(leaves, torch.float32, align=K._LANES,
                          pad_to=K.FLAT_TILE), aligned)

        p32 = state.params.float()
        scale = _local_scale(norms(p32), norms(g32), lr_val,
                             self.trust_coefficient, self.clip, self.eps, wd)
        if wd:
            g32 = g32 + wd * p32
        del p32
        adjusted = g32 * K.expand_per_tensor(scale, spec.sizes, g32.numel())
        # an inner optimizer without an overflow skip (FusedAdagrad)
        # takes no found_inf
        kw = {} if found_inf is False else {"found_inf": found_inf}
        # the weight decay is in the grads: the inner step runs with its
        # own at 0 (LARC.py:87-106)
        saved = getattr(self.optim, "weight_decay", None)
        if saved is not None:
            self.optim.weight_decay = 0.0
        try:
            return self.optim.step_flat(state, adjusted, lr=lr, **kw)
        finally:
            if saved is not None:
                self.optim.weight_decay = saved
