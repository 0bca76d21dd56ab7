"""Per-module loggers with env-var verbosity (counterpart of
apex_tpu/utils/log_util.py).

The package logger is "apex_tpu_torch"; `APEX_TPU_TORCH_VERBOSITY` in
the environment sets its level when this module is first imported.  Its
handler prefixes each line with the root `RankInfoFormatter`'s rank
info (`parallel.mesh.get_rank_info()`).
"""

from __future__ import annotations

import logging
import os


def get_transformer_logger(name: str) -> logging.Logger:
    name_wo_ext = os.path.splitext(name)[0]
    return logging.getLogger(name_wo_ext)


def set_logging_level(verbosity) -> None:
    """Set the package logger's level; the first call also gives it one
    stream handler with the rank-info format (later calls add none).
    The package's NullHandler does not count as one: the JAX package
    tests `logger.handlers` alone, so its own NullHandler keeps the
    stream handler from ever being added there."""
    from apex_tpu_torch import RankInfoFormatter
    logger = logging.getLogger("apex_tpu_torch")
    logger.setLevel(verbosity)
    if not any(isinstance(h, logging.StreamHandler)
               for h in logger.handlers):
        handler = logging.StreamHandler()
        handler.setFormatter(RankInfoFormatter(
            "%(asctime)s [%(rank_info)s] %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)


_env = os.environ.get("APEX_TPU_TORCH_VERBOSITY")
if _env:
    set_logging_level(_env)
