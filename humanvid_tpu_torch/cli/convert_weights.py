"""Checkpoint conversion: released torch weights -> the port's checkpoint
files, and the port's checkpoints -> the reference's ``.pth`` layout.

    # released weights -> <out_dir>/<component>-0.pt for each of the seven modules
    python -m humanvid_tpu_torch.cli.convert_weights import \\
        --base_model pretrained_weights/stable-diffusion-v1-5 \\
        --vae pretrained_weights/sd-vae-ft-mse \\
        --image_encoder pretrained_weights/image_encoder \\
        --denoising_unet denoising_unet-30000.pth \\
        --reference_unet reference_unet-30000.pth \\
        --pose_guider pose_guider-30000.pth \\
        --camera_encoder camera_pose_encoder-30000.pth \\
        --motion_module motion_module-20000.pth \\
        --out_dir converted/

    # <ckpt_dir>/<name>-<step>.pt -> the reference's .pth files
    python -m humanvid_tpu_torch.cli.convert_weights export --ckpt_dir converted \\
        --step 0 --out_dir exported/

The counterpart of ``scripts/convert_weights.py``, with its flags and
``--device`` (the CUDA card unless it names another). ``import`` fills a
zeroed ``CamAnimate`` (weights a file does not hold stay zero, as the JAX
tool's abstract tree is) through ``utils.weights.load_pretrained`` and
writes each module's state dict as ``{component}-0.pt``, which
``train.checkpoint`` loads. ``export`` loads each of ``reference_unet``,
``denoising_unet``, ``pose_guider`` and ``camera_encoder`` whose
``{name}-{step}.pt`` exists (the whole module, strictly) and writes it
through ``train.checkpoint.export_reference_pth``. The system is fp32, the
files' precision.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import torch

EXPORTED = ("reference_unet", "denoising_unet", "pose_guider", "camera_encoder")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    imp = sub.add_parser("import")
    imp.add_argument("--base_model", default="")
    imp.add_argument("--vae", default="")
    imp.add_argument("--image_encoder", default="")
    imp.add_argument("--denoising_unet", default="")
    imp.add_argument("--reference_unet", default="")
    imp.add_argument("--pose_guider", default="")
    imp.add_argument("--camera_encoder", default="")
    imp.add_argument("--motion_module", default="")
    imp.add_argument("--out_dir", required=True)
    imp.add_argument("--stage", type=int, default=2,
                     help="2 = motion modules on (inference_v2)")

    exp = sub.add_parser("export")
    exp.add_argument("--ckpt_dir", required=True)
    exp.add_argument("--step", type=int, required=True)
    exp.add_argument("--out_dir", required=True)
    for s in (imp, exp):
        s.add_argument("--tiny", action="store_true",
                       help="tiny topology (CLI smoke tests)")
        s.add_argument("--device", default="cuda", help="torch device (tests pass cpu)")
    return p.parse_args(argv)


def _system(args):
    from ..pipelines.system import CamAnimate, CamAnimateConfig, tiny_config

    return CamAnimate(tiny_config() if args.tiny else CamAnimateConfig(), device=args.device)


@torch.no_grad()
def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Returns the paths written."""
    args = parse_args(argv)
    from ..train.checkpoint import export_reference_pth, load_checkpoint, save_checkpoint

    system = _system(args)
    if args.cmd == "import":
        from ..utils.weights import load_pretrained

        for module in system.components().values():
            for tensor in module.state_dict().values():
                tensor.zero_()
        load_pretrained(system, {
            "base_model_path": args.base_model,
            "vae_model_path": args.vae,
            "image_encoder_path": args.image_encoder,
            "denoising_unet_path": args.denoising_unet,
            "reference_unet_path": args.reference_unet,
            "pose_guider_path": args.pose_guider,
            "camera_pose_encoder_path": args.camera_encoder,
            "motion_module_path": args.motion_module,
        })
        paths = [save_checkpoint(args.out_dir, name, {k: v.cpu() for k, v in
                                                      module.state_dict().items()}, 0)
                 for name, module in system.components().items()]
    else:
        found = []
        for name in EXPORTED:
            path = os.path.join(args.ckpt_dir, f"{name}-{args.step}.pt")
            if os.path.exists(path):
                getattr(system, name).load_state_dict(load_checkpoint(path), strict=True)
                found.append(name)
        paths = export_reference_pth(system, None, args.out_dir, args.step, found)
    for path in paths:
        print("wrote", path)
    return paths


if __name__ == "__main__":
    main()
