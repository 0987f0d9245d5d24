"""Metric primitives (``core``), copied from ``lightgbm_tpu/telemetry``
without change; the serving layer mounts them. The rest of the JAX
package's ``telemetry/`` (run logs, events, device gauges) is not ported
yet."""
