"""apex_tpu_torch.models — so far GPT (`models.gpt`), BERT
(`models.bert`) and ResNet (`models.resnet`): their configs, seeded
inits, the converters from the JAX package's parameters and the
training forwards."""

from apex_tpu_torch.models.gpt import (  # noqa: F401
    GPT,
    GPT2_350M,
    GPTConfig,
    init_gpt_params,
    params_from_jax,
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
