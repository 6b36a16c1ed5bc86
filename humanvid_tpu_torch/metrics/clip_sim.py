"""CLIP frame consistency: the mean pairwise cosine similarity of the CLIP
vision features of a video's frames (the counterpart of
``humanvid_tpu/metrics/clip_sim.py``; the features come from
``weights.make_clip_apply``)."""

from __future__ import annotations

import torch


def frame_consistency(frame_features) -> float:
    """(f, d) per-frame features -> the mean of the off-diagonal cosine
    similarities, in float32."""
    x = torch.as_tensor(frame_features, dtype=torch.float32)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    sim = x @ x.T
    f = sim.shape[0]
    off = ~torch.eye(f, dtype=torch.bool, device=sim.device)
    return float(sim[off].mean())
