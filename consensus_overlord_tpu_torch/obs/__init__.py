"""Observability: the device profiler and the round-id helpers the
provider binds (the port's own copies of parts of the JAX package's
obs/)."""
