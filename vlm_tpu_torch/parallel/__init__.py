"""Data and tensor parallelism over ``torch.distributed``
(``vlm_tpu/parallel``'s counterparts)."""
