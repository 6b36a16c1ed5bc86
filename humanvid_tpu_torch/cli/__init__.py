"""The command lines: ``python -m humanvid_tpu_torch.cli.pose2vid`` and
``cli.pose2img`` (inference), ``cli.train_stage_1`` and ``cli.train_stage_2``
(training), ``cli.eval_pose2vid`` and ``cli.eval_pose2img`` (evaluation),
``cli.convert_weights`` (released weights in and out)."""
