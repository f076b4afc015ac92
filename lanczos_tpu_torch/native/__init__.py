"""Native (C++) host kernels of the port: the tridiagonal eigensolver (the
implicit-shift QL sweep and Sturm bisection) that the host backends
``native`` and ``bisect`` of :mod:`lanczos_tpu_torch.core.tridiagonal` run.

``host_kernels.cpp`` is the port's own copy of the JAX package's source;
:mod:`.build` compiles it with ``g++`` at first use and
:mod:`.host_kernels` binds it with ``ctypes``.
"""
