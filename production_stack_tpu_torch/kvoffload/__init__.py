"""Local KV offload tiers of the port (host DRAM, disk): serde, tiers and the
engine-side connector, copies of production_stack_tpu/kvoffload/ trimmed to
what the port serves. The cache server, KV-index controller, warm start and
device KV transfer are not ported."""
