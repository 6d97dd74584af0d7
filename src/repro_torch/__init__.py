"""PyTorch and CUDA port of the StoCFL engine (the JAX package ``repro`` is
the reference). It mirrors ``repro``'s module layout; its entry points run
on the GPU unless a caller asks for the CPU, and its hand-written CUDA
kernels live in ``repro_torch.kernels``. Nothing here imports JAX or
``repro``."""
