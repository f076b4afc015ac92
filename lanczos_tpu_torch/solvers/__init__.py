"""solvers layer of lanczos_tpu_torch (mirrors lanczos_tpu.solvers)."""
