from quantizedattention_tpu_torch.serve.engine import GenerationResult, ServingEngine
from quantizedattention_tpu_torch.serve.scheduler import (
    NativeScheduler,
    PyScheduler,
    make_scheduler,
)

__all__ = ["GenerationResult", "ServingEngine", "NativeScheduler", "PyScheduler", "make_scheduler"]
