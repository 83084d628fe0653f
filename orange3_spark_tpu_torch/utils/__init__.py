"""utils/ — the knob registry, the serving and resilience counters, the
liveness heartbeat (copies of the JAX package's modules) and the one
recipe this package captures a CUDA graph with."""
