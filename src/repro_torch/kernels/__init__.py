"""Hand-written Hopper kernels of the port, each as a ``kernel`` (CUDA
binding) / ``ops`` (device dispatch + launch count) / ``ref`` (plain
PyTorch) triple, as in ``repro.kernels``."""
