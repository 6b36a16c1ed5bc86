"""humanvid_tpu_torch: the PyTorch / CUDA port of humanvid_tpu for NVIDIA Hopper.

Camera-controlled human image animation (HumanVid's CamAnimate) with the
JAX package's module layout (``ops/``, ``models/``, ``diffusion/``,
``pipelines/``, ``data/``, ``utils/``). Tensors are NCHW inside the models;
the pipelines take and return the JAX package's channel-last arrays. The
attention and GroupNorm kernels are hand-written CUDA (``csrc/``), built
with ``nvcc`` at first use; on CPU tensors every kernel runs its plain
PyTorch version. ``tools/`` holds the kernel-level measurements
(``python -m humanvid_tpu_torch.tools.microbench``) and their probe kernels.

Entry points: :class:`pipelines.CamAnimate`,
:class:`pipelines.Pose2VideoPipeline`, :class:`pipelines.Pose2ImagePipeline`
and :func:`train.train_step`. They run on the CUDA card unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
