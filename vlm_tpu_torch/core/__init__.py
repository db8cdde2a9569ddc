"""Framework-free helpers of the port (``vlm_tpu/core``'s counterparts)."""
