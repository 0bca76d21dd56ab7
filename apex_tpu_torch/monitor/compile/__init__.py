"""apex_tpu_torch.monitor.compile — the recompile sentry and the OOM
predicate (`watermarks.is_oom`).

The compile report and the memory watermarks of
`apex_tpu.monitor.compile` wait for their own slice of the port."""

from apex_tpu_torch.monitor.compile.sentry import RecompileSentry  # noqa: F401
