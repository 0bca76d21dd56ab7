"""apex_tpu_torch.monitor — so far only the recompile sentry
(`monitor.compile`); the metrics, trace and timeline observatories of
`apex_tpu.monitor` wait for their own slice of the port."""
