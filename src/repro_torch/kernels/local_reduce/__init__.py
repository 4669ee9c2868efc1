from repro_torch.kernels.local_reduce import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
