"""DWPose checkpoints with seeded random values and the upstream key sets.

    python -m humanvid_tpu_torch.tools.make_random_pose_weights OUT_DIR [--seed 0]

Writes ``yolox_l.pth`` (a torch state dict, the YOLOX names) and
``dw-ll_ucoco_384.onnx`` (an ONNX model whose graph holds the mmpose names
as initializers), so that ``tools.prepare_videos`` runs end to end where
the released files are not at hand; the skeletons it draws mean nothing.
Values come from one ``numpy`` generator: convolution and linear weights
N(0, 1 / fan_in), batch-norm scales N(1, 0.05), shifts and running means
N(0, 0.05), running variances U(0.5, 1.5), other biases N(0, 0.05), the
GAU's gamma N(1, 0.05) and beta N(0, 0.05), ScaleNorm gains 1; YOLOX's
stem and prediction layers are then recalibrated (``detecting_yolox``; the
comment above ``STEM_SCALE`` says how) so that NMS keeps a person or a few
a frame, and the pose network and the rasterizer have persons to work on.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..pose.rtmpose import DWPoseModel
from ..pose.yolox import YOLOX

# Random YOLOX weights score every anchor alike (near 0.25 against the 0.5
# threshold) and see little of the frame: interior anchors score within 1e-6
# of each other, so which of them NMS keeps is decided by rounding.
# ``detecting_yolox`` scales the stem for inputs in [0, 255], rescales each
# level's prediction layers so that on a grey frame the objectness and
# person logits have mean PERSON_LOGIT and spread PERSON_SPREAD over the
# anchors and the boxes are near BOX_PIXELS (log-normal, spread
# BOX_SPREAD), then lowers the objectness so that the 0.5 threshold falls
# in the middle of the widest gap between the best TOP_ANCHORS anchors: the
# few that pass stand far from the threshold and from each other, and NMS
# keeps a few person-sized boxes a frame.
STEM_SCALE = 1.0 / 255.0
PERSON_LOGIT, PERSON_SPREAD = -2.0, 1.5
BOX_PIXELS, BOX_SPREAD = 256.0, 0.25
TOP_ANCHORS = 8


def random_state_dict(module: torch.nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """Seeded float32 values for every entry of ``module``'s state dict."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, t in module.state_dict().items():
        shape, leaf = tuple(t.shape), key.rsplit(".", 1)[-1]
        owner = key.rsplit(".", 2)[-2] if key.count(".") else ""
        if leaf == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("running_mean", "bias", "beta"):
            v = rng.normal(0.0, 0.05, shape)
        elif leaf == "g":
            v = np.ones(shape)
        elif leaf == "gamma" or (leaf == "weight" and owner == "bn"):
            v = rng.normal(1.0, 0.05, shape)
        else:  # conv and linear weights
            v = rng.normal(0.0, float(np.prod(shape[1:])) ** -0.5, shape)
        out[key] = v.astype(np.float32)
    return out


def _grey_logits(model: YOLOX, sd: Dict[str, np.ndarray]):
    """Each level's raw head output (4 + 1 + classes, h * w) on a grey
    640x640 letterbox, with weights ``sd``."""
    from ..pose.detector import load_module

    model = load_module(model, sd).eval()
    return [o[0].flatten(1) for o in model.head(model.backbone(torch.full((1, 3, 640, 640),
                                                                           114.0)))]


@torch.no_grad()
def detecting_yolox(model: YOLOX, seed: int) -> Dict[str, np.ndarray]:
    """Seeded weights for ``model`` (any topology, built on the CPU or the
    meta device) that find a few persons a frame: ``random_state_dict``
    with the changes the comment above ``STEM_SCALE`` sets out."""
    from ..pose.yolox import STRIDES

    model = model.to_empty(device="cpu")
    sd = random_state_dict(model, seed)
    sd["backbone.backbone.stem.conv.conv.weight"] *= np.float32(STEM_SCALE)
    for i, (logits, stride) in enumerate(zip(_grey_logits(model, sd), STRIDES)):
        for name, ch, mean, spread in (
                ("obj_preds", 0, PERSON_LOGIT, PERSON_SPREAD),
                ("cls_preds", 0, PERSON_LOGIT, PERSON_SPREAD),
                ("reg_preds", 2, np.log(BOX_PIXELS / stride), BOX_SPREAD),
                ("reg_preds", 3, np.log(BOX_PIXELS / stride), BOX_SPREAD)):
            row = {"reg_preds": ch, "obj_preds": 4, "cls_preds": 5 + ch}[name]
            m, sdev = logits[row].mean().item(), logits[row].std().item()
            gain = spread / max(sdev, 1e-12)
            sd[f"head.{name}.{i}.weight"][ch] *= np.float32(gain)
            b = sd[f"head.{name}.{i}.bias"]
            b[ch] = np.float32((b[ch] - m) * gain + mean)
    # anchor i passes (sigmoid(obj - d) * sigmoid(cls) > 0.5) iff d < t_i
    out = torch.cat(_grey_logits(model, sd), dim=1).double()
    obj, person = out[4], torch.sigmoid(out[5])
    ok = person > 0.5
    t = obj[ok] - torch.logit(0.5 / person[ok])
    t = torch.sort(t, descending=True).values[:TOP_ANCHORS + 1].numpy()
    k = int(np.argmax(t[:-1] - t[1:]))
    shift = np.float32((t[k] + t[k + 1]) / 2)
    for i in range(len(STRIDES)):
        sd[f"head.obj_preds.{i}.bias"] -= shift
    return sd


def _varint(x: int) -> bytes:
    out = b""
    while True:
        b, x = x & 0x7F, x >> 7
        if not x:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _field(num: int, payload: bytes) -> bytes:  # length-delimited
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def onnx_bytes(tensors: Dict[str, np.ndarray]) -> bytes:
    """A ModelProto whose graph holds ``tensors`` as float32 initializers
    (dims, data type 1, name, raw data): what ``pose.onnx_reader`` reads."""
    inits = b""
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr, np.float32)
        dims = b"".join(_varint(1 << 3) + _varint(d) for d in arr.shape)
        inits += _field(5, dims + _varint(2 << 3) + _varint(1) + _field(8, name.encode())
                        + _field(9, arr.tobytes()))
    return _field(7, inits)


def write(out_dir: str, seed: int = 0) -> Dict[str, str]:
    """Write both files; returns their paths by network."""
    os.makedirs(out_dir, exist_ok=True)
    with torch.device("meta"):
        pose = DWPoseModel()
    det_sd = detecting_yolox(YOLOX(), seed)
    paths = {"yolox": os.path.join(out_dir, "yolox_l.pth"),
             "dwpose": os.path.join(out_dir, "dw-ll_ucoco_384.onnx")}
    torch.save({k: torch.from_numpy(v) for k, v in det_sd.items()}, paths["yolox"])
    with open(paths["dwpose"], "wb") as f:
        f.write(onnx_bytes(random_state_dict(pose, seed + 1)))
    return paths


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out_dir")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    for name, path in write(args.out_dir, args.seed).items():
        print(f"{name}: {path}")


if __name__ == "__main__":
    main()
