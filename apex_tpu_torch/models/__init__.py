"""apex_tpu_torch.models — so far GPT (`models.gpt`): its config, seeded
init, the converter from the JAX package's parameters and the training
forward."""

from apex_tpu_torch.models.gpt import (  # noqa: F401
    GPT,
    GPT2_350M,
    GPTConfig,
    init_gpt_params,
    params_from_jax,
)
