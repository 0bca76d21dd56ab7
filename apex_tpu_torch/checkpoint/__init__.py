"""apex_tpu_torch.checkpoint — so far only the fail points the serving
engine checks (`chaos`); the checkpoint writer and readers of
`apex_tpu.checkpoint` wait for their own slice of the port."""
