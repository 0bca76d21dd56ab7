"""ASP, automatic 2:4 structured sparsity (counterpart of
apex_tpu/contrib/sparsity.py, itself ≡ apex.contrib.sparsity,
apex/contrib/sparsity/asp.py:40-213, sparse_masklib.py and
permutation_lib.py).

`create_mask` keeps the two largest magnitudes of every 4 consecutive
elements of a row; `ASP` computes masks for a dict of weights and
re-applies them after each optimizer step; `search_channel_permutation`
looks for a column permutation that keeps more magnitude under the mask
(the reference's Exhaustive_Search with a window of two stripes: every
pair of 4-column stripes takes the best of the 35 splits of its 8
columns into two stripes, the best disjoint improvements are applied
greedily until none is left, then a few random cross-half swaps try to
leave a local optimum).  All of it is sorts and reductions in PyTorch's
own operators, as the JAX package leaves them to XLA, on the weight's
device.  Sorts are stable, so ties (bf16 weights have them) keep the JAX
package's order, and the escape swaps draw from the same
`np.random.RandomState(seed)` stream, so the permutation is the JAX
package's.
"""

from __future__ import annotations

import itertools
from typing import Any, Mapping

import numpy as np
import torch

# the 35 ways to split 8 columns into two unordered groups of 4 (column 0
# fixed in group A), as (A, B) index arrays (the JAX package's table)
_SPLITS8 = None


def _splits8():
    global _SPLITS8
    if _SPLITS8 is None:
        combos = [(0,) + c for c in itertools.combinations(range(1, 8), 3)]
        rest = [tuple(sorted(set(range(8)) - set(c))) for c in combos]
        _SPLITS8 = (np.asarray(combos, np.int32),
                    np.asarray(rest, np.int32))
    return _SPLITS8


def create_mask(weight, pattern: str = "m4n2_1d"):
    """The 2:4 mask along the last dim ≡ sparse_masklib.create_mask: in
    every group of 4 consecutive elements keep the 2 largest magnitudes
    (a tie goes to the later element, as a stable ascending sort ranks
    it), in the weight's dtype."""
    if pattern not in ("m4n2_1d", "m4n2"):
        raise NotImplementedError(f"pattern {pattern}")
    flat = weight.abs().reshape(-1, 4)
    order = torch.argsort(flat, dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(4, device=order.device).expand_as(order))
    return (ranks >= 2).to(weight.dtype).reshape(weight.shape)


def apply_mask(weight, mask):
    return weight * mask


def magnitude_after_mask(weight, mask=None):
    if mask is None:
        mask = create_mask(weight)
    return torch.sum(weight.abs() * mask)


_PAIRS4 = tuple(itertools.combinations(range(4), 2))


def _top2(cols):
    """The sum of the two largest of four magnitudes, from the four
    tensors `cols`: the largest of their six pair sums.  Rounding is
    monotone, so that is bit for bit the JAX package's sorted top two
    added (a + b rounds as b + a), without a sort."""
    best = None
    for i, j in _PAIRS4:
        s = cols[i] + cols[j]
        best = s if best is None else torch.maximum(best, s)
    return best


def _mag4_groups(cols_abs):
    """(..., 4) magnitudes → the sum kept under 2:4 (the top two)."""
    return _top2(cols_abs.unbind(dim=-1))


def _stripe_scores(w_abs, perm):
    """The magnitude each stripe of 4 columns keeps under the mask (S,),
    as a numpy array."""
    cols = w_abs[:, torch.as_tensor(perm, device=w_abs.device)]
    cols = cols.reshape(w_abs.shape[0], -1, 4)
    return _mag4_groups(cols).sum(dim=0).cpu().numpy()


def _score_pairs(w_abs, cols8):
    """cols8 (P, 8) column ids of stripe pairs → the best split's score
    and index (P,), (P,); the first best of the 35 wins, as the JAX
    package's scan keeps it."""
    ga, gb = _splits8()
    w8 = w_abs[:, cols8].unbind(dim=-1)                     # 8 x (R, P)
    best_s = torch.full((cols8.shape[0],), -float("inf"),
                        dtype=w_abs.dtype, device=w_abs.device)
    best_i = torch.zeros(cols8.shape[0], dtype=torch.int32,
                         device=w_abs.device)
    for i in range(ga.shape[0]):
        s = (_top2([w8[j] for j in ga[i]]).sum(dim=0)
             + _top2([w8[j] for j in gb[i]]).sum(dim=0))
        better = s > best_s
        best_s = torch.where(better, s, best_s)
        best_i = torch.where(better, torch.full_like(best_i, i), best_i)
    return best_s, best_i


def _pair_improvements(w_abs, perm, stripe_scores, pair_chunk=8192):
    """The best split of every stripe pair, in chunks of `pair_chunk`
    pairs: (pairs, best score, best split, improvement), numpy."""
    S = len(perm) // 4
    pairs = np.asarray([(a, b) for a in range(S) for b in range(a + 1, S)],
                       np.int32)
    cols = perm.reshape(S, 4)
    best_s = np.empty(len(pairs), np.float32)
    best_i = np.empty(len(pairs), np.int32)
    for lo in range(0, len(pairs), pair_chunk):
        chunk = pairs[lo:lo + pair_chunk]
        cols8 = np.concatenate([cols[chunk[:, 0]], cols[chunk[:, 1]]],
                               axis=1)
        s, i = _score_pairs(w_abs, torch.as_tensor(cols8,
                                                   device=w_abs.device))
        best_s[lo:lo + pair_chunk] = s.cpu().numpy()
        best_i[lo:lo + pair_chunk] = i.cpu().numpy()
    imp = best_s - (stripe_scores[pairs[:, 0]] + stripe_scores[pairs[:, 1]])
    return pairs, best_s, best_i, imp


def _greedy_rounds(w_abs, perm, rel_tol=1e-4, max_rounds=32):
    """Apply the best disjoint pair re-partitions until the best one left
    gains less than `rel_tol` of the kept magnitude (or `max_rounds`)."""
    if len(perm) < 8:
        return perm
    ga, gb = _splits8()
    S = len(perm) // 4
    for _ in range(max_rounds):
        scores = _stripe_scores(w_abs, perm)
        tol = rel_tol * float(scores.sum())
        pairs, _, best_i, imp = _pair_improvements(w_abs, perm, scores)
        order = np.argsort(-imp)
        used = set()
        changed = False
        cols = perm.reshape(S, 4).copy()
        for idx in order:
            if imp[idx] <= tol:
                break
            a, b = pairs[idx]
            if a in used or b in used:
                continue
            cols8 = np.concatenate([cols[a], cols[b]])
            cols[a] = cols8[ga[best_i[idx]]]
            cols[b] = cols8[gb[best_i[idx]]]
            used.update((a, b))
            changed = True
        perm = cols.reshape(-1)
        if not changed:
            break
    return perm


def search_channel_permutation(weight, window: int = 8,
                               escape_attempts: int = 4, seed: int = 0,
                               max_cols: int = 512):
    """The stripe-pair permutation search (the JAX package's): returns
    (permutation, score), score = magnitude_after_mask(weight[:,
    permutation]).  Matrices wider than `max_cols` are searched as two
    halves, then fixed up with a few full-width rounds; only the window
    of two stripes (8) is implemented, as in the JAX package."""
    if window != 8:
        raise NotImplementedError("only the stripe-pair window (8) is "
                                  "supported")
    c = weight.shape[-1]
    if c % 4:
        raise ValueError(f"columns ({c}) must be a multiple of 4")
    w_abs = weight.float().abs()

    def score(perm):
        return float(magnitude_after_mask(
            w_abs[:, torch.as_tensor(perm, device=w_abs.device)]))

    def run(perm0):
        if len(perm0) > max_cols:
            half = (len(perm0) // 8) * 4
            joined = np.concatenate([run(perm0[:half]), run(perm0[half:])])
            return _greedy_rounds(w_abs, joined, max_rounds=4)
        return _greedy_rounds(w_abs, perm0)

    perm = run(np.arange(c))
    best = score(perm)
    rng = np.random.RandomState(seed)
    for _ in range(escape_attempts):
        cand = perm.copy()
        i = rng.randint(0, c // 2)
        j = c // 2 + rng.randint(0, c - c // 2)
        cand[i], cand[j] = cand[j], cand[i]
        cand = _greedy_rounds(w_abs, cand,
                              max_rounds=4 if c > max_cols else 32)
        s = score(cand)
        if s > best + 1e-6:
            perm, best = cand, s
    return perm, best


def _key_str(k):
    """A dict key or list index as the JAX package's path element prints
    (`DictKey` / `SequenceKey`)."""
    return f"[{k!r}]" if isinstance(k, str) else f"[{k}]"


def _walk(tree, fn, path=()):
    if isinstance(tree, Mapping):
        return {k: _walk(v, fn, path + (_key_str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, path + (_key_str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


class ASP:
    """≡ apex.contrib.sparsity.ASP (the JAX package's functional form)
    over a nested dict of tensors: `init_model_for_pruning(params,
    whitelist)` computes the masks and returns the masked tree, `apply`
    re-applies them (after each optimizer step), `sparsity` is the zero
    fraction of the masked leaves.  Masks are keyed by the leaf's path as
    the JAX package prints it, and chosen as it chooses them: a leaf of
    2 or more dims whose last two dims are multiples of 4 and whose path
    names "weight" or ends in "w" (or one of `whitelist`)."""

    def __init__(self, mask_calculator: str = "m4n2_1d",
                 allow_permutation: bool = False):
        self.pattern = mask_calculator
        self.allow_permutation = allow_permutation
        self.masks = {}

    def _eligible(self, path, leaf, whitelist):
        name = "/".join(path).lower()
        if leaf.ndim < 2 or min(leaf.shape[-2:]) % 4 != 0:
            return False
        if whitelist is None:
            return "weight" in name or name.endswith("w")
        return any(w in name for w in whitelist)

    def init_model_for_pruning(self, params: Mapping[str, Any],
                               whitelist=None):
        self.masks = {}

        def visit(path, leaf):
            if self._eligible(path, leaf, whitelist):
                self.masks[path] = create_mask(leaf, self.pattern)
                return leaf * self.masks[path]
            return leaf

        return _walk(params, visit)

    def apply(self, params: Mapping[str, Any]):
        return _walk(params, lambda path, leaf: leaf * self.masks[path]
                     if path in self.masks else leaf)

    def sparsity(self, params=None):
        zeros = total = 0
        for mask in self.masks.values():
            zeros += int((mask == 0).sum())
            total += mask.numel()
        return zeros / max(total, 1)
