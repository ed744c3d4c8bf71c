"""Tensor ops of the port: plain PyTorch, plus the two CUDA kernel wrappers
(``cuda_gn``, ``cuda_a2j``). Import submodules directly; nothing is loaded
here."""
