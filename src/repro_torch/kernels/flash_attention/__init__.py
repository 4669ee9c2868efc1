from repro_torch.kernels.flash_attention.ops import attention

__all__ = ["attention"]
