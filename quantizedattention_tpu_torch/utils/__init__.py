from quantizedattention_tpu_torch.utils.runtime import cdiv, check_status, require_cuda

__all__ = ["cdiv", "check_status", "require_cuda"]
