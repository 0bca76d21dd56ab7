"""apex_tpu_torch.models — so far GPT (`models.gpt`) and BERT
(`models.bert`): their configs, seeded inits, the converter from the JAX
package's parameters and the training forwards."""

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
