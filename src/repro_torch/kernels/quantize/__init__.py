from repro_torch.kernels.quantize import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
