"""apex_tpu_torch.transformer — the single-device training step, the
tensor-parallel layers at tp=1 and the attention softmax dispatch of
`functional` (counterpart of apex_tpu.transformer)."""
