from quantizedattention_tpu_torch.parallel.kv_cache import (
    QuantizedKVCache,
    append_kv,
    decode_attention,
    decode_attention_plain,
    init_kv_cache,
    write_kv_slot,
)

__all__ = [
    "QuantizedKVCache",
    "append_kv",
    "decode_attention",
    "decode_attention_plain",
    "init_kv_cache",
    "write_kv_slot",
]
