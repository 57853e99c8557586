"""PyTorch/CUDA port of the JAX package, for one NVIDIA H100 (sm_90a).

The JAX package beside this one is the reference: every module here
mirrors the JAX module of the same path and is held against it by the
`tests/test_torch_*.py` parity tests. This package imports `torch`, never
`jax`, and nothing of the JAX package.

Every Pallas kernel of the JAX package is a hand-written Hopper kernel in
CUDA C++; the first three are on the flagship video model's path
(SAViDiffusion, MOVi-E 128x128):

- `ops/fused_norm.py`: GroupNorm(+SiLU) (`csrc/group_norm.cu`).
- `ops/attention_kernel.py`: clamped-exp multi-head attention
  (`csrc/attention.cu`).
- `ops/slot_attention_kernel.py`: all slot-attention iterations in one
  kernel, one thread-block cluster per item (`csrc/slot_attention.cu`).
- `ops/winograd_conv.py`: Winograd F(2x2,3x3) convolution
  (`csrc/winograd.cu`), which no model calls.

The CUDA sources are compiled by `nvcc` into one shared library with a
plain C interface at first use (`ops/_cuda.py`), loaded with `ctypes`.
Each kernel wrapper takes its plain PyTorch version only for a tensor on
the CPU; on a CUDA tensor it launches the kernel or raises.
"""
