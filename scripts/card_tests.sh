#!/usr/bin/env bash
# The port's card-only tests: every CUDA kernel against its plain PyTorch
# version (tests/test_torch_cuda_attention.py); sleep mode's freed bytes,
# restored weights and kernel outputs after wake, with the device telemetry
# (tests/test_torch_cuda_surface.py); and the Mixtral MoE and LoRA forwards
# through the kernels (tests/test_torch_cuda_moe_lora.py); both kernels at the
# per-rank head shapes of tensor-parallel serving (a KV head shared by tp 4
# ranks among them), and LoRA at tp 2 against
# tp 1 (tests/test_torch_cuda_tp.py);
# both kernels at the dp ranks' row shapes and a dp 2 engine's replicas
# (tests/test_torch_cuda_dp.py); the prefill kernel at step_spec's verify
# shape (on a pipeline stage's 2-layer pool too), step_spec and
# step_multi_pipelined through the kernels, and a chain's fetch groups
# arriving through their events (tests/test_torch_cuda_spec.py); disaggregated prefill's device path: a
# page copied over CUDA IPC between two processes, the offer retirement, a
# producer process shipping every page device to device, a killed
# producer's pages falling back to TCP blobs, and a staged page's restore
# queued behind other work while more pulls land (tests/test_torch_cuda_disagg.py);
# live migration between two engines through the kernels, over the KV fabric
# and through a shared disk tier, the restored pages byte for byte
# (tests/test_torch_cuda_fleet.py); both kernels at mixtral-8x7b's ep 2 x tp 2,
# pp 2 x ep 2 and sp 2 x ep 2 rank shapes and Qwen2.5-1.5B's tp 4 rank (3
# query heads on one shared KV head), an ep 2 engine's replicas and a pp 2 x
# ep 2 engine's stage ranks (tests/test_torch_cuda_ep.py); a pp 2
# engine's forward against pp 1's, both kernels launched by every stage
# (tests/test_torch_cuda_pp.py); the decode kernel at a sequence rank's
# shapes (beside dp and pp ranks too: a dp 2 x sp 2 rank's rows, a pp 2 x
# sp 2 stage rank's microbatch) and an sp 2 engine's forward against one
# rank's, the decode kernel launched by every sequence rank and no prefill
# kernel (tests/test_torch_cuda_sp.py); a pp 2 engine over two host processes
# (a follower host subprocess, process id 1) against pp 1's forward, both
# kernels launched by the stage on each host (tests/test_torch_cuda_multihost.py).
# No file imports jax. Run on a machine with an NVIDIA GPU; tests/conftest.py imports jax,
# which that machine may lack, so pytest skips conftest files.
#
#   bash scripts/card_tests.sh [pytest arguments]
set -euo pipefail
cd "$(dirname "$0")/.."
exec python3 -m pytest --noconftest -m cuda tests/test_torch_cuda_attention.py tests/test_torch_cuda_surface.py \
    tests/test_torch_cuda_moe_lora.py tests/test_torch_cuda_tp.py tests/test_torch_cuda_dp.py \
    tests/test_torch_cuda_spec.py tests/test_torch_cuda_disagg.py tests/test_torch_cuda_fleet.py \
    tests/test_torch_cuda_ep.py tests/test_torch_cuda_pp.py tests/test_torch_cuda_sp.py \
    tests/test_torch_cuda_multihost.py \
    -q -p no:cacheprovider "$@"
