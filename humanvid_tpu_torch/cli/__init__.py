"""The inference command lines: ``python -m humanvid_tpu_torch.cli.pose2vid``
and ``python -m humanvid_tpu_torch.cli.pose2img``."""
