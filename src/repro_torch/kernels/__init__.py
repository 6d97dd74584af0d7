"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the ``ops`` dispatcher. Importing this package builds nothing: the CUDA
library is compiled at the first launch (``kernels._build``)."""
