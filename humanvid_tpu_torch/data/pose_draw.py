"""OpenPose-style skeleton rasterization (the DWPose canvas format), in numpy.

The counterpart of ``humanvid_tpu/data/pose_draw.py``, which draws every
stroke with OpenCV. The card's machine has no OpenCV, so this module carries
its own integer versions of the four OpenCV primitives that rasterizer uses,
with OpenCV's arithmetic, so that a pose dict gives the same canvas bits:

- ``ellipse2Poly``: the one-degree sine table (7 decimals, as float32),
  points rounded half to even, consecutive duplicates dropped;
- ``fillConvexPoly``: the 8-connected outline (Bresenham at shift 0, the
  16.16 fixed-point walk at shift 16), then the scan of two edges in 16.16;
- the filled ``circle`` (the midpoint walk, one span per row);
- ``line`` at thickness 2: a 16.16 quadrilateral around the segment and
  filled circles of radius 1 at both ends.

Colours are OpenCV's: float components rounded half to even, saturated to
uint8. The drawing rules (limb topology, the 18-colour wheel, stroke width
5 for the body, the 0.6 dimming, HSV hand and foot edges, white face dots,
the UE ``scale``) are the JAX module's. Input keypoints are normalized to
[0, 1]; invisible points are < eps or -1 (body subset). The canvas is RGB
uint8 on black.
"""

from __future__ import annotations

import colorsys
import math
from typing import Dict, Sequence

import numpy as np

EPS = 0.01

BODY_LIMB_SEQ = [
    [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
    [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
    [1, 16], [16, 18], [3, 17], [6, 18],
]

BODY_COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85],
]

HAND_EDGES = [
    [0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7], [7, 8],
    [0, 9], [9, 10], [10, 11], [11, 12], [0, 13], [13, 14], [14, 15],
    [15, 16], [0, 17], [17, 18], [18, 19], [19, 20],
]

FOOT_EDGES = [[0, 2], [0, 3], [0, 4], [1, 5], [1, 6], [1, 7]]

# the body's 0.6 dimming, (canvas * 0.6).astype(np.uint8), as a table
_DIM = (np.arange(256) * 0.6).astype(np.uint8)

# ---------------------------------------------------------------------------
# OpenCV's drawing arithmetic
# ---------------------------------------------------------------------------

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# sin of 0..450 degrees as OpenCV tabulates it: 7 decimals, stored as float
_SIN = np.round(np.sin(np.radians(np.arange(451))), 7).astype(np.float32).astype(np.float64)


def _tdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _color(color) -> np.ndarray:
    """OpenCV's ``saturate_cast<uchar>`` of each component."""
    return np.clip(np.rint(np.asarray(color, np.float64)), 0, 255).astype(np.uint8)


def ellipse2poly(center, axes, angle: int, arc_start: int = 0, arc_end: int = 360,
                 delta: int = 1) -> np.ndarray:
    """OpenCV's integer ``ellipse2Poly``: (n, 2) int64 points."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    cos_a, sin_a = _SIN[450 - angle], _SIN[angle]
    arc = np.minimum(np.arange(arc_start, arc_end + delta, delta), arc_end)
    arc = np.where(arc < 0, arc + 360, arc)
    x = axes[0] * _SIN[450 - arc]
    y = axes[1] * _SIN[arc]
    px = np.rint(center[0] + x * cos_a - y * sin_a).astype(np.int64)
    py = np.rint(center[1] + x * sin_a + y * cos_a).astype(np.int64)
    pts = np.stack([px, py], axis=1)
    keep = np.ones(len(pts), bool)
    keep[1:] = (pts[1:] != pts[:-1]).any(axis=1)
    pts = pts[keep]
    if len(pts) == 1:
        pts = np.array([center, center], np.int64)
    return pts


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on a width x height box: the clipped segment,
    or None where none of it is inside."""
    if width <= 0 or height <= 0:
        return None
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """OpenCV's 8-connected Bresenham ``Line`` (its LineIterator, left to
    right), clipped to the image."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        x1, y1, x2, y2 = x2, y2, x1, y1
        dx, dy = -dx, -dy
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    # the minor steps taken before pixel k: err_j = major - 2 minor (j + 1)
    # + 2 major m_j steps the minor axis whenever it is negative, which is
    # m_k = ceil((2 minor k - major) / (2 major)) clamped at 0 (k >= 1)
    m = np.zeros_like(k)
    if major:
        m[1:] = np.maximum(0, -((major - 2 * minor * k[1:]) // (2 * major)))
    if dy > dx:
        ys, xs = y1 + sy * k, x1 + m
    else:
        xs, ys = x1 + k, y1 + sy * m
    img[ys, xs] = color


def _line2(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """OpenCV's ``Line2``: the outline walk of a 16.16 fixed-point segment."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    pts = [((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)]
    k = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        xs, ys = (x1 >> XY_SHIFT) + k, (y1 + k * y_step) >> XY_SHIFT
    else:
        xs, ys = (x1 + k * x_step) >> XY_SHIFT, (y1 >> XY_SHIFT) + k
    xs = np.concatenate([[pts[0][0]], xs])
    ys = np.concatenate([[pts[0][1]], ys])
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[inside], xs[inside]] = color


def _fill_convex_poly(img: np.ndarray, v: np.ndarray, color, shift: int = 0) -> None:
    """OpenCV's ``FillConvexPoly`` with 8-connected edges: the outline, then
    one span a row between the two edges, stepped in 16.16 fixed point."""
    h, w = img.shape[:2]
    v = [(int(x), int(y)) for x, y in v]
    npts = len(v)
    delta = (1 << shift) >> 1
    half = XY_ONE >> 1
    p0 = (v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift))
    for x, y in v:
        p = (x << (XY_SHIFT - shift), y << (XY_SHIFT - shift))
        if shift == 0:
            _line8(img, p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT, p[0] >> XY_SHIFT,
                   p[1] >> XY_SHIFT, color)
        else:
            _line2(img, p0[0], p0[1], p[0], p[1], color)
        p0 = p
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    imin = int(np.argmin(ys))
    xmin, xmax = (min(xs) + delta) >> shift, (max(xs) + delta) >> shift
    ymin, ymax = (min(ys) + delta) >> shift, (max(ys) + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs_, xe_ = v[idx0][0], v[idx][0]
                        if shift != XY_SHIFT:
                            xs_ <<= XY_SHIFT - shift
                            xe_ <<= XY_SHIFT - shift
                        e[4] = ty
                        e[3] = _tdiv((xe_ - xs_) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs_
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0][2] > edge[1][2] else (edge[0], edge[1])
            x1 = (left[2] + half) >> XY_SHIFT
            x2 = (right[2] + half) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _circle(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """OpenCV's filled ``Circle`` (LINE_8, shift 0): the midpoint walk, a
    span on each of the four rows it reaches a step, clipped."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, xl, xr in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= y < h and xr >= 0 and xl < w:
                img[y, max(xl, 0):min(xr, w - 1) + 1] = color
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def fill_convex_poly(img: np.ndarray, points: np.ndarray, color) -> None:
    """``cv2.fillConvexPoly(img, points, color)`` (LINE_8, shift 0)."""
    _fill_convex_poly(img, np.asarray(points).reshape(-1, 2), _color(color), 0)


def circle(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, thickness=-1)``."""
    _circle(img, int(center[0]), int(center[1]), int(radius), _color(color))


def line2(img: np.ndarray, pt1, pt2, color) -> None:
    """``cv2.line(img, pt1, pt2, color, thickness=2)``: the segment clipped
    to the image grown by the thickness on every side, then a 16.16
    quadrilateral one unit either side of it and filled circles of radius 1
    at both ends."""
    color = _color(color)
    h, w = img.shape[:2]
    clipped = _clip_line(w + 4, h + 4, int(pt1[0]) + 2, int(pt1[1]) + 2,
                         int(pt2[0]) + 2, int(pt2[1]) + 2)
    if clipped is None:
        return
    x1, y1, x2, y2 = ((v - 2) << XY_SHIFT for v in clipped)
    dx, dy = (x1 - x2) / XY_ONE, (y2 - y1) / XY_ONE
    r = dx * dx + dy * dy
    if abs(r) > np.finfo(np.float64).eps:
        r = XY_ONE / math.sqrt(r)  # thickness 2 << (XY_SHIFT - 1), even
        ddx, ddy = int(np.rint(dy * r)), int(np.rint(dx * r))
        quad = [(x1 + ddx, y1 + ddy), (x1 - ddx, y1 - ddy), (x2 - ddx, y2 - ddy),
                (x2 + ddx, y2 + ddy)]
        _fill_convex_poly(img, quad, color, XY_SHIFT)
    for x, y in ((x1, y1), (x2, y2)):
        _circle(img, (x + (XY_ONE >> 1)) >> XY_SHIFT, (y + (XY_ONE >> 1)) >> XY_SHIFT, 1, color)


# ---------------------------------------------------------------------------
# the DWPose canvas
# ---------------------------------------------------------------------------

def _hsv_rgb(h: float) -> tuple:
    # float components, as the reference passes matplotlib's hsv_to_rgb * 255
    # to OpenCV, which rounds them (half to even)
    r, g, b = colorsys.hsv_to_rgb(h, 1.0, 1.0)
    return (r * 255.0, g * 255.0, b * 255.0)


def draw_bodypose(canvas: np.ndarray, candidate: np.ndarray, subset: np.ndarray,
                  scale: float = 1.0) -> np.ndarray:
    H, W, _ = canvas.shape
    # width 5: the data-prep rasterizer the PoseGuider was trained on
    stickwidth = int(np.round(5 * scale))
    candidate = np.asarray(candidate)
    subset = np.asarray(subset)

    for i in range(17):
        for person in subset:
            index = person[np.array(BODY_LIMB_SEQ[i]) - 1]
            if -1 in index:
                continue
            y = candidate[index.astype(int), 0] * float(W)
            x = candidate[index.astype(int), 1] * float(H)
            mx, my = x.mean(), y.mean()
            length = float(np.hypot(x[0] - x[1], y[0] - y[1]))
            angle = math.degrees(math.atan2(x[0] - x[1], y[0] - y[1]))
            polygon = ellipse2poly((int(my), int(mx)), (int(length / 2), stickwidth),
                                   int(angle), 0, 360, 1)
            fill_convex_poly(canvas, polygon, BODY_COLORS[i])

    canvas = _DIM[canvas]

    for i in range(18):
        for person in subset:
            index = int(person[i])
            if index == -1:
                continue
            px, py = candidate[index][0:2]
            circle(canvas, (int(px * W), int(py * H)), int(np.round(4 * scale)),
                   BODY_COLORS[i])
    return canvas


def draw_handpose(canvas: np.ndarray, all_hand_peaks: Sequence[np.ndarray],
                  scale: float = 1.0) -> np.ndarray:
    H, W, _ = canvas.shape
    for peaks in all_hand_peaks:
        peaks = np.asarray(peaks)
        for ie, (a, b) in enumerate(HAND_EDGES):
            x1, y1 = (peaks[a] * (W, H)).astype(int)
            x2, y2 = (peaks[b] * (W, H)).astype(int)
            if min(x1, y1, x2, y2) > EPS:
                line2(canvas, (x1, y1), (x2, y2), _hsv_rgb(ie / len(HAND_EDGES)))
        for px, py in peaks:
            x, y = int(px * W), int(py * H)
            if x > EPS and y > EPS:
                circle(canvas, (x, y), int(np.round(4 * scale)), (0, 0, 255))
    return canvas


def draw_facepose(canvas: np.ndarray, all_lmks: Sequence[np.ndarray],
                  scale: float = 1.0) -> np.ndarray:
    H, W, _ = canvas.shape
    for lmks in all_lmks:
        for px, py in np.asarray(lmks):
            x, y = int(px * W), int(py * H)
            if x > EPS and y > EPS:
                circle(canvas, (x, y), int(np.round(3 * scale)), (255, 255, 255))
    return canvas


def draw_footpose(canvas: np.ndarray, all_foot_peaks: Sequence[np.ndarray],
                  scale: float = 1.0) -> np.ndarray:
    """Feet: 6 points a person, the reference's extension."""
    H, W, _ = canvas.shape
    for peaks in all_foot_peaks:
        peaks = np.asarray(peaks)
        for ie, (a, b) in enumerate(FOOT_EDGES):
            if a >= len(peaks) or b >= len(peaks):
                continue
            x1, y1 = (peaks[a] * (W, H)).astype(int)
            x2, y2 = (peaks[b] * (W, H)).astype(int)
            x1 = int(x1 + (x2 - x1) * 0.1)
            y1 = int(y1 + (y2 - y1) * 0.1)
            if min(x1, y1, x2, y2) > EPS:
                line2(canvas, (x1, y1), (x2, y2), _hsv_rgb(ie / len(FOOT_EDGES)))
        for px, py in peaks[2:]:
            x, y = int(px * W), int(py * H)
            if x > EPS and y > EPS:
                circle(canvas, (x, y), int(np.round(4 * scale)), (0, 255, 0))
    return canvas


def draw_pose(pose: Dict[str, np.ndarray], H: int, W: int,
              scale: float = 1.0) -> np.ndarray:
    """Rasterize a pose dict {bodies:{candidate,subset}, hands, faces[, feet]}
    onto a black (H, W, 3) RGB canvas. ``scale`` is the UE data-prep
    convention: stroke widths scale with ``max(H, W) / 1920``; the real-video
    path uses 1."""
    canvas = np.zeros((H, W, 3), dtype=np.uint8)
    bodies = pose["bodies"]
    canvas = draw_bodypose(canvas, bodies["candidate"], bodies["subset"], scale)
    if pose.get("hands") is not None:
        canvas = draw_handpose(canvas, pose["hands"], scale)
    if pose.get("faces") is not None:
        canvas = draw_facepose(canvas, pose["faces"], scale)
    if pose.get("feet") is not None:
        canvas = draw_footpose(canvas, pose["feet"], scale)
    return canvas
