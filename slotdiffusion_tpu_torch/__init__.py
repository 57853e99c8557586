"""PyTorch/CUDA port of the JAX package, for one NVIDIA H100 (sm_90a).

The JAX package beside this one is the reference: every module here
mirrors the JAX module of the same path and is held against it by the
`tests/test_torch_*.py` parity tests. This package imports `torch`, never
`jax`, and nothing of the JAX package.

The three Pallas kernels on the serving path of the flagship video model
(SAViDiffusion, MOVi-E 128x128) are hand-written Hopper kernels:

- `ops/fused_norm.py`: GroupNorm(+SiLU), Triton.
- `ops/attention_kernel.py`: clamped-exp multi-head attention, CUDA C++
  (`csrc/attention.cu`).
- `ops/slot_attention_kernel.py`: all slot-attention iterations in one
  kernel, CUDA C++ (`csrc/slot_attention.cu`).

The CUDA sources are compiled by `nvcc` into one shared library with a
plain C interface at first use (`ops/_cuda.py`), loaded with `ctypes`.
Each kernel wrapper takes its plain PyTorch version only for a tensor on
the CPU; on a CUDA tensor it launches the kernel or raises.
"""
