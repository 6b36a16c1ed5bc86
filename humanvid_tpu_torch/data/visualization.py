"""Dataset visualization: camera-frustum 3D plots, Plücker PCA to RGB, arrays
to images.

The counterpart of ``humanvid_tpu/data/visualization.py`` (the reference's
``src/dataset/visualization_utils.py``): ``CameraPoseVisualizer``
(matplotlib 3D frustum pyramids a camera pose, coloured along the
trajectory; matplotlib is imported where it is used), ``pca_visualize``
(a 6-channel Plücker video projected to its 3 principal components as RGB),
``to_image`` (CHW or HWC float to HWC uint8) and ``sample_composite``, whose
resize and write go through the port's ``video_io`` (the antialiased
bilinear ``resize_frames``, ``write_image``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class CameraPoseVisualizer:
    """3D frustum plot of c2w poses (matplotlib, lazy import)."""

    def __init__(self, xlim=(-1, 1), ylim=(-1, 1), zlim=(-1, 1)):
        import matplotlib.pyplot as plt

        self.plt = plt
        self.fig = plt.figure(figsize=(7, 7))
        self.ax = self.fig.add_subplot(projection="3d")
        self.ax.set_aspect("auto")
        self.ax.set_xlim(xlim)
        self.ax.set_ylim(ylim)
        self.ax.set_zlim(zlim)
        self.ax.set_xlabel("x")
        self.ax.set_ylabel("y")
        self.ax.set_zlabel("z")

    def add_pose(self, c2w: np.ndarray, color="b", focal_scale: float = 0.1,
                 aspect: float = 16 / 9):
        """Draw one camera as a pyramid frustum from its c2w matrix."""
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        w = focal_scale * aspect
        h = focal_scale
        d = focal_scale * 1.5
        corners = np.array([
            [0, 0, 0, 1],
            [w, h, d, 1], [-w, h, d, 1], [-w, -h, d, 1], [w, -h, d, 1],
        ]).T  # (4, 5)
        pts = (np.asarray(c2w) @ corners).T[:, :3]  # (5, 3)
        faces = [
            [pts[0], pts[1], pts[2]], [pts[0], pts[2], pts[3]],
            [pts[0], pts[3], pts[4]], [pts[0], pts[4], pts[1]],
            [pts[1], pts[2], pts[3], pts[4]],
        ]
        self.ax.add_collection3d(
            Poly3DCollection(faces, facecolors=color, linewidths=0.3,
                             edgecolors=color, alpha=0.25)
        )

    def add_trajectory(self, c2ws: Sequence[np.ndarray], cmap: str = "rainbow",
                       **kwargs):
        import matplotlib

        n = len(c2ws)
        # matplotlib.cm.get_cmap was removed in 3.9; colormaps[] is the API
        colors = matplotlib.colormaps[cmap](np.linspace(0, 1, max(n, 2)))
        for i, pose in enumerate(c2ws):
            self.add_pose(pose, color=colors[i], **kwargs)

    def save(self, path: str):
        self.fig.savefig(path, bbox_inches="tight")
        self.plt.close(self.fig)


def pca_visualize(plucker: np.ndarray) -> np.ndarray:
    """Plücker video (f, H, W, 6) -> (f, H, W, 3) uint8 via PCA to RGB."""
    x = np.asarray(plucker, np.float64)
    f, h, w, c = x.shape
    flat = x.reshape(-1, c)
    flat = flat - flat.mean(axis=0)
    # principal axes of the 6-d embedding
    _, _, vt = np.linalg.svd(flat[:: max(1, flat.shape[0] // 65536)], full_matrices=False)
    proj = flat @ vt[:3].T  # (N, 3)
    lo, hi = proj.min(axis=0), proj.max(axis=0)
    rgb = (proj - lo) / np.maximum(hi - lo, 1e-8)
    return (rgb.reshape(f, h, w, 3) * 255).astype(np.uint8)


def to_image(tensor: np.ndarray, value_range: tuple = (-1.0, 1.0)) -> np.ndarray:
    """Float image in ``value_range`` (HWC or CHW) -> HWC uint8."""
    x = np.asarray(tensor, np.float32)
    if x.ndim == 3 and x.shape[0] in (1, 3) and x.shape[-1] not in (1, 3):
        x = x.transpose(1, 2, 0)
    lo, hi = value_range
    x = (x - lo) / (hi - lo)
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def sample_composite(sample: dict, out_path: Optional[str] = None) -> np.ndarray:
    """Ref | tgt | pose | Plücker-PCA composite for one dataset sample
    (the reference datasets' visualize_dataset dump)."""
    from .video_io import resize_frames, write_image

    ref = to_image(sample["ref"])
    tgt = sample["tgt"]
    tgt_img = to_image(tgt[0] if tgt.ndim == 4 else tgt)
    pose = sample["pose"]
    pose_img = to_image(pose[0] if pose.ndim == 4 else pose, (0.0, 1.0))
    plk = sample["plucker"]
    plk_vid = plk[None] if plk.ndim == 3 else plk
    plk_img = pca_visualize(plk_vid)[0]
    h = min(im.shape[0] for im in (ref, tgt_img, pose_img, plk_img))
    row = np.concatenate(
        [resize_frames(im[None], int(im.shape[1] * h / im.shape[0]), h)[0]
         for im in (ref, tgt_img, pose_img, plk_img)], axis=1)
    if out_path:
        write_image(out_path, row)
    return row
