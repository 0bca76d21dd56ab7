"""apex_tpu_torch.transformer — the single-device training step and the
tensor-parallel layers at tp=1 (counterpart of apex_tpu.transformer)."""
