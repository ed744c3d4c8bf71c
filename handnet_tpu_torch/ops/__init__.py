"""Tensor ops of the port: plain PyTorch (among them ``offset_field``, the
joint-offset field), plus the three CUDA kernel wrappers (``cuda_gn``,
``cuda_a2j``, ``cuda_int8_conv``). Import submodules directly; nothing is
loaded here."""
