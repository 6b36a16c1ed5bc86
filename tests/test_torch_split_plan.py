"""Kernel B's split kernels (a head wider than 160 columns, up to 32 frames),
on the CPU: their plan as a pure function, and its agreement with the CUDA
sources that check it on the card.

- ``split_plan`` at every d from 168 to 1280 (a multiple of 8; wider than
  160 after the wrapper's pad to 8, so from 161) and every f from 1 to 32,
  forward and backward: 2, 4 or 8 column slices of at most 160 columns
  that cover each of the head's columns once, every consumer warp working,
  a ring of at least 2 tensor slots (4 where the backward keeps its item
  for both sweeps), and shared memory, reckoned as the kernels lay it out,
  that a block can use.
- The sizes the wrappers pass for the heads64 path's wide shapes.
- ``csrc/temporal_split.cuh``'s constants, modes and shared-memory
  reckoning are the wrapper's, and both entry points route a head in
  slices at f <= 32 to the split kernels.
- Every split variant of ``tools/flash_variants.py`` finds its edits' text
  and runs a plan at some wide shape of its tables.
"""

import re

import pytest

from humanvid_tpu_torch.ops import cuda_build
from humanvid_tpu_torch.ops import temporal_attention as ta
from humanvid_tpu_torch.tools import flash_variants as fv

WIDE = list(range(168, ta.MAX_HEAD_DIM + 1, 8))


@pytest.mark.parametrize("f", range(1, ta.ITEM_FRAMES + 1))
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_split_plan_fits_and_covers_every_column(f, backward):
    for d in WIDE:
        p = ta.split_plan(d, f, backward)
        assert p.slices in (2, 4, 8) and p.positions * p.slices == ta.SPLIT_WARPS, (d, f)
        assert p.cols % 8 == 0 and p.cols <= ta.CHUNK_COLUMNS
        if backward:
            # narrower slices where they cover the head and the ring of the
            # 160-column ones is not full
            wide = ta._split_plan(d, f, True, max_slice=ta.CHUNK_COLUMNS)
            try:
                narrow = ta.split_slices(d, ta.SPLIT_BWD_SLICE)
            except ValueError:
                narrow = None
            if narrow and wide.stages < ta.SPLIT_MAX_STAGES:
                assert (p.slices, p.cols) == narrow
            else:
                assert p == wide
        # slices 0 .. slices-2 take cols columns, the last the rest, none empty
        starts = [s * p.cols for s in range(p.slices)]
        widths = [min(p.cols, d - s0) for s0 in starts]
        assert min(widths) > 0 and sum(widths) == d
        covered = sorted(c for s0, w in zip(starts, widths) for c in range(s0, s0 + w))
        assert covered == list(range(d))
        assert p.cols + 8 <= p.padded <= 256 and (p.padded // 8) % 2 == 1
        assert p.smem == ta.split_smem(f, p.padded, p.stages) <= ta.SMEM_LIMIT
        # as deep as fits, up to the deepest ring
        assert (p.stages == ta.SPLIT_MAX_STAGES
                or ta.split_smem(f, p.padded, p.stages + 1) > ta.SMEM_LIMIT)
        if not backward:
            assert p.mode == ta.MODE_SPLIT and p.stages >= 2
        elif p.stages >= ta.SPLIT_RESIDENT_STAGES:
            assert p.mode == ta.MODE_SPLIT
        else:
            assert p.mode == ta.MODE_SPLIT_STREAMED and p.stages >= 2


def test_split_plan_at_named_widths():
    # heads64's motion levels 2-3 (d 256 over 24 frames): 4 positions x 2
    # slices of 128, three slots of 52 KB; the backward loads q, k and g again
    assert ta.split_plan(256, 24) == ta.SplitPlan(ta.MODE_SPLIT, 2, 128, 136, 4, 3, 189744)
    # the backward: 2 positions x 4 slices of 64, seven slots (q, k and g
    # loaded again for the second sweep: eight keep the item)
    assert ta.split_plan(256, 24, True) == ta.SplitPlan(ta.MODE_SPLIT_STREAMED, 4, 64, 72, 2, 7,
                                                        226672)
    assert ta.split_plan(256, 16, True).mode == ta.MODE_SPLIT
    # one frame: 8 slots either way, the 128-column slices kept
    assert ta.split_plan(256, 1, True)[1:5] == (2, 128, 136, 4)
    # past 8 x 80 columns the backward's slices are the forward's
    assert ta.split_plan(648, 24, True)[1:3] == ta.split_plan(648, 24)[1:3] == (8, 88)
    # one 1280-wide head: 8 slices of 160 a position; 2 slots at 32 frames
    assert ta.split_plan(1280, 32)[1:6] == (8, 160, 168, 1, 2)
    # two uneven slices (136 + 128) forward, four (3 x 72 + 48) backward; at
    # 13 frames the backward keeps its item
    assert ta.split_plan(264, 13)[1:5] == (2, 136, 152, 4)
    p = ta.split_plan(264, 13, True)
    assert (p.slices, p.cols, p.positions) == (4, 72, 2) and p.mode == ta.MODE_SPLIT
    # 480 columns: 4 slices of 120 (3 of 160 would leave warps idle)
    assert ta.split_plan(480, 24)[1:5] == (4, 120, 136, 2)


def test_split_plan_variants_and_limits():
    # fewer working warps: 2 positions of 2 slices keep the backward's item at 24 frames
    p = ta._split_plan(256, 24, True, max_slice=160, positions=2)
    assert p.positions == 2 and p.stages >= ta.SPLIT_RESIDENT_STAGES and p.mode == ta.MODE_SPLIT
    assert p.smem == ta.split_smem(24, 136, p.stages, 4)
    # narrower slices take more of them
    assert ta._split_plan(256, 24, max_slice=80)[1:5] == (4, 64, 72, 2)
    assert ta._split_plan(320, 24, max_stages=2).stages == 2
    with pytest.raises(ValueError, match="split kernels take"):
        ta.split_plan(160, 24)
    with pytest.raises(ValueError, match="split kernels take"):
        ta.split_plan(256, 33)
    with pytest.raises(ValueError, match="no column slices"):
        ta._split_plan(1280, 24, max_slice=80)
    with pytest.raises(ValueError, match="no split plan"):  # one item needs four slots
        ta._split_plan(1280, 32, True, mode=ta.MODE_SPLIT)


@pytest.mark.parametrize("shape,heads,backward,sizes", [
    # heads64 level 2 (768x512 forward, 896x512 stage 2) and level 3/mid, d 256
    ((1, 24, 384, 1280), 5, False, (1, 24, 384, 5, 256, 4, 136, 2, 256, 4, 3, 189744)),
    ((1, 24, 448, 1280), 5, True, (1, 24, 448, 5, 256, 2, 72, 4, 256, 5, 7, 226672)),
    ((1, 24, 96, 1280), 5, False, (1, 24, 96, 5, 256, 4, 136, 2, 256, 4, 3, 189744)),
    # one frame: 8 slots, the backward's item kept
    ((8, 1, 448, 1280), 1, True, (8, 1, 448, 1, 1280, 1, 168, 8, 1280, 4, 8, 33152)),
    # d <= 160: the item kernels, as before
    ((1, 24, 448, 1280), 8, True, (1, 24, 448, 8, 160, 1, 168, 1, 160, 0, 0, 0)),
])
def test_launch_sizes_of_split_heads(shape, heads, backward, sizes):
    fn = ta.backward_launch_sizes if backward else ta.forward_launch_sizes
    assert fn(shape, heads) == sizes
    # a zero-padded head (d 196 -> 200): the kernel's width, the true scale
    assert fn((1, 24, 8, 2 * 200), 2, 196)[4:9] == ((200, 2, 72, 4, 196) if backward
                                                    else (200, 4, 120, 2, 196))


def test_split_sources_reckon_as_the_wrapper():
    """The constants, modes and shared-memory reckoning of
    csrc/temporal_split.cuh are the wrapper's, and both entry points send
    a head in slices at f <= 32 to the split kernels with the plan's
    checks."""
    text = (cuda_build.CSRC / "temporal_split.cuh").read_text()

    def const(key):
        return int(re.search(rf"constexpr int {key} = (\d+);", text).group(1))

    assert const("kWarps") == ta.SPLIT_WARPS and const("kMaxStages") == ta.SPLIT_MAX_STAGES
    assert const("kMaxSlice") == ta.CHUNK_COLUMNS and const("kPiece") == 64
    assert "constexpr int kModeSplit = 4, kModeSplitStreamed = 5;" in text
    assert (ta.MODE_SPLIT, ta.MODE_SPLIT_STREAMED) == (4, 5)
    assert "return (F * cwp + 63) / 64 * 64;" in text
    assert "constexpr int exchange_floats(int MT) { return 256 * MT * MT; }" in text
    assert const("kReady") == ta.SPLIT_READY > ta.SPLIT_MAX_STAGES
    assert ("return 128 + (size_t)stages * warps * tile_elems(F, cwp) * 2 +\n"
            "         (size_t)warps * exchange_floats(MT) * 4 + room_bytes(F, cwp, warps) +\n"
            "         (size_t)stages * 16 + kReady * 8;") in text
    assert ("const int over = (16 * MT - F) * cwp * 2 - warps * exchange_floats(MT) * 4;\n"
            "  return over > 0 ? (over + 15) / 16 * 16 : 0;") in text
    assert text.count("const int MT = F <= 16 ? 1 : 2;") == 2
    assert "smem <= 232448" in text and ta.SMEM_LIMIT == 232448
    # 24 frames, 136 columns, 3 slots of 8 tiles: 3264-element tiles, the
    # 32 KB exchange (no room past it), 6 slot and 16 ready barriers, 128
    # bytes of alignment
    assert ta.split_smem(24, 136, 3) == 128 + 3 * 8 * 3264 * 2 + 8 * 4096 + 48 + 128
    # 1 frame: tiles rounded to 64 elements, the 8 KB exchange
    assert ta.split_smem(1, 168, 8) == 128 + 8 * 8 * 192 * 2 + 8 * 1024 + 128 + 128
    # 1 frame, 2 working warps: the 2 KB exchange and the room for the 16-row
    # tiles' 15 rows past the last (15 x 136 x 2 - 2048 bytes)
    assert ta.split_smem(1, 136, 8, 2) == 128 + 8 * 2 * 192 * 2 + 2048 + 2032 + 128 + 128
    for name, least in (("temporal_attention.cu", "2"),
                        ("temporal_attention_bwd.cu", "streamed ? 2 : 4")):
        source = (cuda_build.CSRC / name).read_text()
        assert '#include "temporal_split.cuh"' in source
        assert "const bool sliced = F <= kMaxFrames && chunks > 1;" in source
        assert (f"!split::plan_ok(F, d, chunks, heads_per_item, CW, cwp, stages, {least}, smem)"
                in source)
        assert "wide_kernel" not in source
    # the forward's O by a store warp, the backward's gradients by each consumer
    fwd, bwd = ((cuda_build.CSRC / name).read_text()
                for name in ("temporal_attention.cu", "temporal_attention_bwd.cu"))
    assert "constexpr int kSplitThreads = 32 * (split::kWarps + 2);" in fwd
    assert "constexpr int kSplitThreads = 32 * (split::kWarps + 1);" in bwd
    assert "split::store_output(" in fwd and "split::store_output(" not in bwd


SPLIT_VARIANT_NAMES = [(n, b) for b in (False, True) for n in fv._split_table(b)]


@pytest.mark.parametrize("name,backward", SPLIT_VARIANT_NAMES,
                         ids=[f"{n}-{'bwd' if b else 'fwd'}" for n, b in SPLIT_VARIANT_NAMES])
def test_split_variants_edit_the_source_and_plan(name, backward):
    """Every split variant of ``flash_variants --temporal`` / ``--temporal-bwd``
    finds its edits' text (in the source, or in the header it inlines) and
    runs a plan at some wide shape of the tables, which differs from the
    kernel's where the variant edits nothing."""
    base = (cuda_build.CSRC / ("temporal_attention_bwd.cu" if backward
                               else "temporal_attention.cu")).read_text()
    text = fv.split_variant_source(name, backward)
    header_edits, fwd_edits, bwd_edits, kwargs, _ = fv._split_table(backward)[name]
    assert (text != base) == bool(header_edits or (bwd_edits if backward else fwd_edits))
    if header_edits:
        assert '#include "temporal_split.cuh"' not in text and "namespace split {" in text
    shapes = fv.TEMPORAL_BWD_SHAPES if backward else fv.TEMPORAL_SHAPES
    plans = [fv.split_variant_plan(name, c // h, f, backward)
             for _, b, f, l, c, h in shapes if c // h > ta.CHUNK_COLUMNS]
    assert any(p is not None for p in plans)
    for p in plans:
        if p is not None:
            assert p.smem <= ta.SMEM_LIMIT and p.positions * p.slices <= kwargs.get(
                "warps", ta.SPLIT_WARPS)
