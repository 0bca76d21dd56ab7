"""apex_tpu_torch.models — so far GPT (`models.gpt`), MoE-GPT
(`models.moe_gpt`), BERT (`models.bert`) and ResNet (`models.resnet`):
their configs, seeded inits, the converters from the JAX package's
parameters and the training forwards."""

from apex_tpu_torch.models.gpt import (  # noqa: F401
    GPT,
    GPT2_1p3B,
    GPT2_350M,
    GPTConfig,
    gpt_1p3b,
    gpt_350m,
    init_gpt_params,
    params_from_jax,
)
from apex_tpu_torch.models.moe_gpt import (  # noqa: F401
    MOE_GPT_350M_8E,
    MoEGPT,
    MoEGPTConfig,
    build_moe_train_step,
    moe_smoke_config,
)
from apex_tpu_torch.models.bert import (  # noqa: F401
    Bert,
    BertConfig,
    bert_large,
    init_bert_params,
)
from apex_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    resnet18,
    resnet50,
)
