"""The data layer of the zero-shot path: the port's own copies of
``vlm_tpu.data``'s dataset readers, label parsers, dataset registry and
tokenizers, and the batcher's background prefetch."""
