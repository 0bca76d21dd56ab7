"""Global args / timers registry (counterpart of
apex_tpu/transformer/testing/global_vars.py): the Megatron-style global
`args`, timers and tensorboard-writer singletons."""

from __future__ import annotations

from apex_tpu_torch.utils.timers import Timers

_GLOBAL_ARGS = None
_GLOBAL_TIMERS = None
_GLOBAL_TENSORBOARD_WRITER = None
_GLOBAL_AUTORESUME = None


def get_args():
    assert _GLOBAL_ARGS is not None, "args is not initialized."
    return _GLOBAL_ARGS


def get_timers():
    assert _GLOBAL_TIMERS is not None, "timers is not initialized."
    return _GLOBAL_TIMERS


def get_tensorboard_writer():
    return _GLOBAL_TENSORBOARD_WRITER


def get_adlr_autoresume():
    return _GLOBAL_AUTORESUME


def set_global_variables(args=None, extra_args_provider=None, defaults={},
                         ignore_unknown_args=False):
    """Set the global args (parsed from sys.argv when not given) and a
    fresh `Timers`; returns the args."""
    global _GLOBAL_ARGS, _GLOBAL_TIMERS
    if args is None:
        from apex_tpu_torch.transformer.testing.arguments import parse_args
        args = parse_args(extra_args_provider, defaults,
                          ignore_unknown_args)
    _GLOBAL_ARGS = args
    _GLOBAL_TIMERS = Timers()
    return args
