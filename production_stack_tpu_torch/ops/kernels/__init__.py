"""Hand-written CUDA kernels of the port (sources in ../../csrc), each with
its plain PyTorch version beside it and a launch counter on its wrapper."""

# shapes both attention kernels take (csrc/*.cu instantiate these)
HEAD_DIMS = (64, 128)
MAX_GROUP = 8  # query heads per KV head: rows of the decode kernel's 16-row mma tile (one warp
# each in its f32 fold), and at least 8 tokens x G heads in each of the prefill kernel's 64-row
# warpgroups
