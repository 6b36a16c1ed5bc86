"""Measurements on the CUDA card: kernel-level (``microbench``, with the
kernels of its probes in ``probe_kernels``), kernel variants
(``flash_variants``) and the training steps' peak memory
(``train_memcheck``); and the evaluation path's tools: metric-network
checkpoints with seeded random values (``make_random_metric_weights``) and
the quality gate at the protocol's shape (``eval_gate``); and the
data-preparation path's: DWPose skeleton videos from a videos tree
(``prepare_videos``) and the training meta JSONs (``build_meta``)."""
