"""File formats of the port: the safetensors reader and writer, and the
port's own model checkpoint (``vlm_tpu/utils``'s counterparts)."""
