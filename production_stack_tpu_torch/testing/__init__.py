"""The stack's test fleet for the port, copies of production_stack_tpu/testing/:
the fake engine (fault injection, directory, fabric and migration in the real
wire shapes), the fake Kubernetes apiserver, the trace generator and the
subprocess helpers. None of them imports the JAX package or torch."""
