"""Ports of the JAX package's kernel studies in ``experiments/``.

Each module is the counterpart of one study script there, named without
the ``pallas_`` prefix, with the study's Pallas kernel as a CUDA kernel of
``csrc/`` beside its plain PyTorch version:

- :mod:`.bcgs_kernel` (``pallas_bcgs_kernel.py``): E2a, the block-MGS pass;
- :mod:`.bcgs_kernel2` (``pallas_bcgs_kernel2.py``): E2b, the classical
  pass in one launch;
- :mod:`.bcgs_kernel3` (``pallas_bcgs_kernel3.py``): E2c, the classical
  pass whose projection reads a bf16 shadow of the basis;
- :mod:`.bcgs_k2_tiny` (``pallas_bcgs_k2_tiny.py``): E2b against float64
  classical GS;
- :mod:`.carry_copy_bench` (``carry_copy_bench.py``): E3, the in-place row
  write, and the Krylov-buffer carry variants around it;
- :mod:`.spmv_bench` (``pallas_spmv_bench.py``): E1, the three BSR SpMV
  variants with G row blocks per CTA, beside K2 and the plain
  gather+einsum.

Each study runs on the card as ``python -m lanczos_tpu_torch.experiments.<name>``.
"""
