"""Device ops of the port: each kernel wrapper beside its plain version.

- ``attention.flash_attention`` (B1; ``FlashAttentionFn``, its
  differentiable form, where a gradient is needed) / ``attention_plain``
- ``decode_attention.decode_attention`` (B2) / ``decode_attention_plain``
- ``kvcache.kv_uniform_write``, ``kv_scatter_write`` (B3) / ``kv_masked_write``
- ``preprocess.normalize_images`` (B4) / ``normalize_plain``
"""
