"""KV offload tiers and the KV services of the port, copies of
production_stack_tpu/kvoffload/: serde (blobs), tiers (host DRAM, disk, the
remote cache server), the engine-side connector, the cache server, the
KV-index controller behind kvaware routing, and warm-start manifests. The
fleet KV directory and device KV transfer are not ported."""
