"""KV offload tiers and the KV services of the port, copies of
production_stack_tpu/kvoffload/: serde (blobs), tiers (host DRAM, disk, the
remote cache server), the engine-side connector, the cache server (which
hosts the fleet KV directory of kvdirectory/), the KV-index controller
behind kvaware routing, warm-start manifests, and disaggregated prefill's KV
transfer (TCP blobs, and the device path on CUDA IPC)."""
