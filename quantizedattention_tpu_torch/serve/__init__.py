from quantizedattention_tpu_torch.serve.engine import (
    GenerationResult,
    ServingEngine,
    make_sharded_decode_step,
    make_sharded_prefill_chunk,
    make_sharded_prefill_slot,
    make_sharded_verify_step,
    serving_shardings,
)
from quantizedattention_tpu_torch.serve.scheduler import (
    NativePager,
    NativeScheduler,
    PyPager,
    PyScheduler,
    make_pager,
    make_scheduler,
)

__all__ = ["GenerationResult", "ServingEngine", "NativePager", "NativeScheduler", "PyPager",
           "PyScheduler", "make_pager", "make_scheduler", "make_sharded_decode_step",
           "make_sharded_prefill_chunk", "make_sharded_prefill_slot", "make_sharded_verify_step",
           "serving_shardings"]
