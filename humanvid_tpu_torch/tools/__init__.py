"""Kernel-level measurements on the CUDA card (``microbench``) and the
kernels of their probes (``probe_kernels``)."""
