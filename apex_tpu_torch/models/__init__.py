"""apex_tpu_torch.models — so far the GPT config, its seeded init and the
converter from the JAX package's parameters (`models.gpt`)."""

from apex_tpu_torch.models.gpt import (  # noqa: F401
    GPT2_350M,
    GPTConfig,
    init_gpt_params,
    params_from_jax,
)
