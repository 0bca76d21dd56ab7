"""apex_tpu_torch.transformer — the single-device training step, the
tensor-parallel layers at tp=1, the attention softmax dispatch of
`functional` and the model-parallel-aware GradScaler of `amp`
(counterpart of apex_tpu.transformer)."""
