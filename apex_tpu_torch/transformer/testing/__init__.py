"""apex_tpu_torch.transformer.testing (counterpart of
apex_tpu.transformer.testing): the toy modules, the argument parser and
the global state of test harnesses, and the standalone models' names
(`StandaloneGPT`, `StandaloneBert`: the port's GPT and BERT)."""

from apex_tpu_torch.transformer.testing.commons import (  # noqa: F401
    IdentityLayer,
    MyLayer,
    MyModel,
    ToyParallelMLP,
    set_random_seed,
)
from apex_tpu_torch.transformer.testing.global_vars import (  # noqa: F401
    get_args,
    get_timers,
    set_global_variables,
)

from apex_tpu_torch.models.gpt import GPT as StandaloneGPT  # noqa: F401
from apex_tpu_torch.models.bert import Bert as StandaloneBert  # noqa: F401
