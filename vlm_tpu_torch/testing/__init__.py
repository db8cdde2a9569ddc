"""Helpers for holding the port against ``vlm_tpu``."""
