"""production_stack_tpu_torch — the serving engine of production_stack_tpu
ported to PyTorch and CUDA on NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports nothing of it.
Its attention runs through hand-written CUDA kernels (ops/kernels, sources
in csrc/) built with nvcc at first use into build/torch_kernels/.
"""

__version__ = "0.1.0"
