"""ops layer of lanczos_tpu_torch (mirrors lanczos_tpu.ops)."""
