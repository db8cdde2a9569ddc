"""Host-side data helpers the serving path needs without ``vlm_tpu.data``."""
