"""What torch.profiler captures of short kernel launches, and where it puts them.

``chip_smoke.py`` reads a kernel's device time from torch.profiler sessions
of three launches each. On the H100 such sessions at times capture no
launch at all, for minutes on end, while long sessions (a denoise step)
still capture. This tool asks why, on kernel B's item forward (24 frames)
and its long forward (48 frames):

1. sessions of the item kernel before any launch of the long one, then
   sessions of the long kernel (its first launch inside one), then of the
   item kernel again;
2. for ``--minutes``, every ROUND_SECONDS, four sessions of three
   launches, each a way ``chip_smoke.py`` could take them: CUDA activity
   only (as the smoke), the same with ``--pad`` seconds of host pause
   before the launches and after the synchronize, CPU and CUDA activity
   with a ``record_function`` mark around the launches, and the item
   kernel as the smoke takes it; between them the plain version and SDPA
   on the same inputs, as the smoke's cases run them.

Each session prints the launches it captured, the runtime API records,
and where the first kernel starts: from the session's trace start
(CUDA-only sessions, less the pad) and from the mark's start (the CPU
session). A clock offset that grows past a session's length drops every
launch of a short session and only the edges of a long one.

    python -m humanvid_tpu_torch.tools.profiler_window --minutes 6 \\
        --out profiler_window.jsonl
"""

from __future__ import annotations

import argparse
import json
import time

import torch

ITEM = (1, 24, 6144, 320, 8)   # kernel B's item forward at the main path's level 0
LONG = (1, 48, 6144, 320, 8)   # its long forward at the long_wide path's level 0
MARK = "hv_window_mark"
ROUND_SECONDS = 2.0  # from one round of the four sessions to the next


def session(fn, key: str, pad: float = 0.0, cpu: bool = False) -> dict:
    """One torch.profiler session over three calls of ``fn``: the launches
    of kernels whose names contain ``key`` it captured, its device and
    runtime records, and the first such kernel's start in ms from the
    trace start (less ``pad``) and, with ``cpu``, from the mark's start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        if pad:
            time.sleep(pad)
        with record_function(MARK):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        if pad:
            time.sleep(pad)
    results = prof.profiler.kineto_results
    events = results.events()
    device = [e for e in events if e.device_type() == DeviceType.CUDA]
    kernels = sorted((e for e in device if key in e.name()), key=lambda e: e.start_ns())
    runtime = [e for e in events if e.name().startswith("cudaLaunchKernel")]
    rec = dict(key=key, pad=pad, cpu=cpu, captured=len(kernels), device_records=len(device),
               runtime_records=len(runtime), from_trace_ms=None, from_mark_ms=None,
               kernel_ms=None)
    if kernels:
        rec["from_trace_ms"] = (kernels[0].start_ns() - results.trace_start_ns()) / 1e6 - pad * 1e3
        rec["kernel_ms"] = sum(e.duration_ns() for e in kernels) / 1e6 / len(kernels)
        marks = [e for e in events if e.name() == MARK]
        if marks:
            rec["from_mark_ms"] = (kernels[0].start_ns() - marks[0].start_ns()) / 1e6
    return rec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--minutes", type=float, default=6.0)
    parser.add_argument("--pad", type=float, default=0.05, help="host pause (s) a side")
    parser.add_argument("--out", default=None, help="a JSON line a session")
    args = parser.parse_args(argv)

    from humanvid_tpu_torch.ops import cuda_build
    from humanvid_tpu_torch.ops import temporal_attention as ta

    cuda_build.build(["temporal_attention"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def inputs(b, f, l, c, heads):
        return [torch.randn((b, f, l, c), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(3)]

    item, long = inputs(*ITEM), inputs(*LONG)
    heads = ITEM[-1]

    def item_fn():
        return ta.temporal_attention_cuda(*item, heads)

    def long_fn():
        return ta.temporal_attention_cuda(*long, heads)

    def load():  # what the smoke runs between two of its sessions
        ta.temporal_attention_plain(*long, heads)
        b, f, l, c, h = LONG
        split = [t.view(b, f, l, h, c // h).permute(0, 2, 3, 1, 4) for t in long]
        torch.nn.functional.scaled_dot_product_attention(*split)
        torch.cuda.synchronize()

    out = open(args.out, "w") if args.out else None
    t0 = time.perf_counter()

    def emit(stage, rec):
        rec = dict(stage=stage, t_s=round(time.perf_counter() - t0, 3), **rec)
        if out:
            out.write(json.dumps(rec) + "\n")
        return rec

    print("[profiler_window] " + torch.cuda.get_device_name(0))
    # 1. before and after the long kernel's first launch (inside a session)
    for stage, fn, key in (("item before", item_fn, "temporal_fwd_kernel"),
                           ("long first", long_fn, "temporal_fwd_long_kernel"),
                           ("item after", item_fn, "temporal_fwd_kernel")):
        recs = [emit(stage, session(fn, key) if stage != "long first" or i else
                     _first_inside(long_fn, key)) for i in range(4)]
        print(f"  {stage}: captured {[r['captured'] for r in recs]} of 3, from trace ms "
              f"{[r['from_trace_ms'] and round(r['from_trace_ms'], 3) for r in recs]}")
    # 2. the four session kinds over time
    kinds = (("smoke", long_fn, "temporal_fwd_long_kernel", 0.0, False),
             ("padded", long_fn, "temporal_fwd_long_kernel", args.pad, False),
             ("cpu mark", long_fn, "temporal_fwd_long_kernel", 0.0, True),
             ("item", item_fn, "temporal_fwd_kernel", 0.0, False))
    tally = {name: [0, 0] for name, *_ in kinds}
    minute, mark = 0, None
    while time.perf_counter() - t0 < args.minutes * 60:
        start = time.perf_counter()
        for name, fn, key, pad, cpu in kinds:
            rec = emit(name, session(fn, key, pad, cpu))
            tally[name][0] += rec["captured"] == 3
            tally[name][1] += 1
            load()
            if name == "cpu mark" and rec["from_mark_ms"] is not None:
                mark = rec
        if (time.perf_counter() - t0) // 60 > minute or \
                time.perf_counter() - t0 >= args.minutes * 60:
            minute += 1
            print(f"  to {time.perf_counter() - t0:.0f} s: sessions that captured all 3 "
                  f"launches {json.dumps({k: f'{a}/{n}' for k, (a, n) in tally.items()})}; "
                  f"last CPU-mark offset "
                  f"{mark and round(mark['from_mark_ms'], 3)} ms, trace offset "
                  f"{mark and round(mark['from_trace_ms'], 3)} ms")
            tally = {name: [0, 0] for name, *_ in kinds}
        time.sleep(max(0.0, ROUND_SECONDS - (time.perf_counter() - start)))
    if out:
        out.close()
    return 0


def _first_inside(fn, key: str) -> dict:
    """A session whose first call is the kernel's first launch in the
    process (no warm-up call before it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    results = prof.profiler.kineto_results
    kernels = sorted((e for e in results.events()
                      if e.device_type() == DeviceType.CUDA and key in e.name()),
                     key=lambda e: e.start_ns())
    return dict(key=key, pad=0.0, cpu=False, captured=len(kernels), first_launch=True,
                from_trace_ms=(kernels[0].start_ns() - results.trace_start_ns()) / 1e6
                if kernels else None)


if __name__ == "__main__":
    raise SystemExit(main())
