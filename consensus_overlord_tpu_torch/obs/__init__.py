"""Observability, the port's own copies of the JAX package's obs/:
metrics.py (the metric surface, its own registry, and the /metrics,
/statusz and /debug exporter), logctx.py (logging and trace-context
propagation), tracing.py (Jaeger span export), flightrec.py (the event
ring), prof.py (the device profiler and the torch.profiler capture
session), fleet.py (round ids, the straggler detector, the fleet
aggregator), telemetry.py (the drift sampler), anomaly.py (EWMA alerts)
and causal.py (the commit tracer).  Import the submodules directly."""
