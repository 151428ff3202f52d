from quantizedattention_tpu_torch.serve.engine import GenerationResult, ServingEngine
from quantizedattention_tpu_torch.serve.scheduler import (
    NativePager,
    NativeScheduler,
    PyPager,
    PyScheduler,
    make_pager,
    make_scheduler,
)

__all__ = ["GenerationResult", "ServingEngine", "NativePager", "NativeScheduler", "PyPager",
           "PyScheduler", "make_pager", "make_scheduler"]
