from apex_tpu_torch.transformer._data._batchsampler import (  # noqa: F401
    MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler,
)
