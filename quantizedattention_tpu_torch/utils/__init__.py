from quantizedattention_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    restore_train_state,
    save_checkpoint,
    train_state,
)
from quantizedattention_tpu_torch.utils.failure import (
    FailureEvent,
    StepGuard,
    Watchdog,
    device_heartbeat,
    hosts_alive,
)
from quantizedattention_tpu_torch.utils.profiling import (
    KernelTiming,
    attention_flops,
    graph_seconds,
    time_attention,
)
from quantizedattention_tpu_torch.utils.runtime import cdiv, check_status, require_cuda

__all__ = [
    "FailureEvent",
    "KernelTiming",
    "StepGuard",
    "Watchdog",
    "attention_flops",
    "cdiv",
    "check_status",
    "device_heartbeat",
    "graph_seconds",
    "hosts_alive",
    "load_checkpoint",
    "require_cuda",
    "restore_train_state",
    "save_checkpoint",
    "time_attention",
    "train_state",
]
