"""Meta-info command line: extract or merge the training meta JSONs.

    python -m humanvid_tpu_torch.tools.build_meta extract --videos_dir data/pexels/videos \\
        --human_csv data/pexels/humans.csv --segment 10 --split_orientation \\
        --out data/meta/pexels
    python -m humanvid_tpu_torch.tools.build_meta merge --inputs a.json b.json --out m.json

The counterpart of ``tools/build_meta.py`` (the reference's per-source
``tools/extract_*_meta_info.py``, ``merge_all_meta_info.py`` and
``get_video_segments.py``), over ``data/meta_tools.py``. ``extract`` keeps
the clips whose ``dwpose`` (and ``camera``) siblings exist and agree on
length, optionally cuts them into segments of ``--segment`` seconds, and
writes one JSON, or one a orientation with ``--split_orientation``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..data.meta_tools import (
    extract_meta,
    load_human_counts,
    merge_meta,
    save_meta,
    segment_meta,
    split_by_orientation,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("extract")
    e.add_argument("--videos_dir", required=True)
    e.add_argument("--out", required=True, help="output path or prefix")
    e.add_argument("--human_csv", default=None)
    e.add_argument("--max_humans", type=int, default=1)
    e.add_argument("--no_camera", action="store_true")
    e.add_argument("--no_length_check", action="store_true")
    e.add_argument("--segment", type=float, default=0.0, help="seconds per segment")
    e.add_argument("--split_orientation", action="store_true")

    m = sub.add_parser("merge")
    m.add_argument("--inputs", nargs="+", required=True)
    m.add_argument("--out", required=True)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.cmd == "merge":
        merged = merge_meta(args.inputs, args.out)
        print(f"merged {len(merged)} entries -> {args.out}")
        return

    counts = load_human_counts(args.human_csv) if args.human_csv else None
    entries = extract_meta(
        args.videos_dir,
        require_camera=not args.no_camera,
        check_lengths=not args.no_length_check,
        human_counts=counts,
        max_humans=args.max_humans,
    )
    if args.segment > 0:
        entries = segment_meta(entries, args.segment)
    if args.split_orientation:
        for k, v in split_by_orientation(entries).items():
            path = f"{args.out}_{k}.json"
            save_meta(v, path)
            print(f"{len(v)} {k} entries -> {path}")
    else:
        save_meta(entries, args.out if args.out.endswith(".json") else args.out + ".json")
        print(f"{len(entries)} entries -> {args.out}")


if __name__ == "__main__":
    main()
