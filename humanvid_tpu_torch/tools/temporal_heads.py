"""Kernel B's backward past 32 frames and in column slices, head by head,
against rounding.

The card tests hold the frames backward's and the split backward's
gradients whole by relative L2 and each head by its largest error, the
long backward's each head by both.
This tool prints, for each gradient and each head, the relative L2 of the
kernel's result from the plain version on the card, beside two readings
of rounding alone at the same inputs: the plain version on the CPU (the same steps, other summation
orders in its products), and the plain version on the card with the frames
reversed (the softmax's sums and the products' reductions in another
order; reversed back after). A head whose kernel reading stands far above
both is a fault, not rounding.

The inputs are the card test's (``test_temporal_long_redesign_matches_plain``,
``test_temporal_frames_backward_matches_plain`` and
``test_temporal_split_kernels_match_plain``): b = 2, a ragged L, each
tensor drawn from its own seed on the card, bf16.

    python -m humanvid_tpu_torch.tools.temporal_heads \\
        --out temporal_heads.jsonl
"""

from __future__ import annotations

import argparse
import json

import torch

# (name, f, l, c, heads, first seed): the long backward's test shapes at
# d = 8 and 40, the frames kernel's at 128 frames (its widest reach), and
# the split kernel's at d = 264 (slices of 72, 72, 72 and 48 columns) and
# at heads64's d = 256
CASES = (("long f200 d8", 200, 7, 32, 4, 120),
         ("long f136 d8", 136, 7, 32, 4, 120),
         ("long f256 d8", 256, 7, 32, 4, 120),
         ("long f200 d40", 200, 7, 320, 8, 120),
         ("frames f128 d8", 128, 11, 32, 4, 80),
         ("frames f128 d40", 128, 11, 320, 8, 80),
         ("split f13 d264", 13, 11, 2640, 10, 140),
         ("split f16 d264", 16, 11, 2640, 10, 140),
         ("split f24 d264", 24, 11, 2640, 10, 140),
         ("split f32 d264", 32, 11, 2640, 10, 140),
         ("split f24 d256", 24, 11, 1280, 5, 140))


def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    norm = want.norm().item()
    return (got - want).norm().item() / norm if norm else 0.0


def readings(case, dev) -> dict:
    from humanvid_tpu_torch.ops import temporal_attention as ta

    name, f, l, c, heads, seed = case
    d = c // heads

    def randn(s):
        gen = torch.Generator(device=dev).manual_seed(s)
        return torch.randn((2, f, l, c), generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, g = (randn(seed + s) for s in range(4))
    kernel = ta.temporal_attention_backward_cuda(q, k, v, g, heads)
    plain = ta.temporal_attention_backward_plain(q, k, v, g, heads)
    cpu = ta.temporal_attention_backward_plain(*(t.cpu() for t in (q, k, v, g)), heads)
    flipped = ta.temporal_attention_backward_plain(*(t.flip(1) for t in (q, k, v, g)), heads)
    rec = dict(case=name, f=f, l=l, d=d, heads=heads, grads={})
    for i, grad in enumerate(("dq", "dk", "dv")):
        want = plain[i]
        rows = {"kernel": kernel[i], "plain on the CPU": cpu[i].to(dev),
                "plain, frames reversed": flipped[i].flip(1)}
        rec["grads"][grad] = {
            label: dict(whole=rel_l2(got, want),
                        heads=[rel_l2(got[..., h * d:(h + 1) * d], want[..., h * d:(h + 1) * d])
                               for h in range(heads)])
            for label, got in rows.items()}
    return rec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="a JSON line a case")
    args = parser.parse_args(argv)

    from humanvid_tpu_torch.ops import cuda_build

    cuda_build.build(["temporal_attention_bwd"])
    dev = torch.device("cuda")
    out = open(args.out, "w") if args.out else None
    print(f"[temporal_heads] {torch.cuda.get_device_name(0)}: relative L2 from the plain "
          f"version on the card, whole and by head")
    for case in CASES:
        rec = readings(case, dev)
        if out:
            out.write(json.dumps(rec) + "\n")
        for grad, rows in rec["grads"].items():
            for label, r in rows.items():
                print(f"  {rec['case']} {grad} {label}: whole {r['whole']:.3e}, heads "
                      f"{' '.join(f'{x:.3e}' for x in r['heads'])}")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
