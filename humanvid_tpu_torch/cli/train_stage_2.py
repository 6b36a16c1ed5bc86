"""Stage-2 (pose2vid) training from a train config.

    python -m humanvid_tpu_torch.cli.train_stage_2 --config configs/train/stage2.yaml

The counterpart of ``scripts/train_stage_2.py``: clips of
``data.n_sample_frames`` at a random stride, the motion modules and the
camera encoder trained, ``motion_module``/``camera_encoder``/``opt_state``
checkpoints with the last 10 kept. The loop, the config keys and the flags
are :mod:`humanvid_tpu_torch.cli.train_stage_1`'s.
"""

from __future__ import annotations

from typing import Optional, Sequence

from . import train_stage_1


def main(argv: Optional[Sequence[str]] = None) -> None:
    train_stage_1.main(argv, stage=2)


if __name__ == "__main__":
    main()
