"""apex_tpu_torch.utils (counterpart of apex_tpu.utils): the phase
timers and the per-module loggers."""

from apex_tpu_torch.utils.timers import Timers, _Timer  # noqa: F401
from apex_tpu_torch.utils.log_util import (  # noqa: F401
    get_transformer_logger, set_logging_level)
