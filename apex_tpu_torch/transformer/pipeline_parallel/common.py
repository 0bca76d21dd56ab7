"""Pipeline-parallel helpers (counterpart of
apex_tpu/transformer/pipeline_parallel/common.py; only the weight-decay
grouping is ported so far)."""

from __future__ import annotations

from typing import Mapping, Sequence


def get_params_for_weight_decay_optimization(
        params, no_decay_names: Sequence[str] = ("bias", "norm", "bn",
                                                 "scale", "offset")):
    """A boolean tree over `params` (nested dicts of tensors), True where
    a leaf takes weight decay: the optimizers' `wd_mask` (≡ the JAX
    package's helper, leaf for leaf).  A leaf whose lowercase key path
    holds one of `no_decay_names` gets none (biases, norm parameters);
    any other leaf gets weight decay iff it has two or more dims."""

    def decide(path, tree):
        if isinstance(tree, Mapping):
            return {k: decide(path + (str(k),), v) for k, v in tree.items()}
        p = "/".join(path).lower()
        if any(n in p for n in no_decay_names):
            return False
        return hasattr(tree, "ndim") and tree.ndim >= 2

    return decide((), params)
