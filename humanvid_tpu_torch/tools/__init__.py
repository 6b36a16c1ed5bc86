"""Measurements on the CUDA card: kernel-level (``microbench``, with the
kernels of its probes in ``probe_kernels``), kernel variants
(``flash_variants``) and the training steps' peak memory
(``train_memcheck``)."""
