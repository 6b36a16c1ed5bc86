"""Core UNet layers: resnet blocks, spatial transformers, temporal transformers.

Layout: spatial tensors are NCHW with batch and frame axes flattened together,
``((b f), c, h, w)``; the frame count is passed alongside. Attention and
feed-forward layers take tokens ``(B, L, c)``. Temporal modules stay in the
spatial token layout ``((b f), l, c)`` and attend over frames through
kernel B, so no module rearranges to ``((b l), f, c)``.

Parameter names follow the reference's diffusers / AnimateDiff state dicts.

Training levers (inert under ``torch.no_grad`` / ``inference_mode``):
``ff_chunk_tokens`` runs the feed-forward over token chunks, each recomputed
in the backward, and the UNet's ``gradient_checkpointing`` recomputes each
resnet, spatial transformer and motion module (:func:`checkpointed`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import MultiHeadAttention
from ..ops.conv import nearest_up2_conv3x3
from ..ops.embeddings import sinusoidal_positional_encoding
from ..ops.group_norm import group_norm_act


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H*W, C)."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w, c)


def from_tokens(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H*W, C) -> (N, C, H, W)."""
    n, _, c = x.shape
    return x.reshape(n, h, w, c).permute(0, 3, 1, 2)


def checkpointed(enabled: bool, fn, *args):
    """``fn(*args)``; when ``enabled`` and autograd is recording, its
    activations are dropped and recomputed in the backward."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def gn(norm: nn.GroupNorm, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
    """``norm``'s GroupNorm (optionally + SiLU) through kernel C; the module
    only holds the parameters."""
    return group_norm_act(x, norm.weight, norm.bias, norm.num_groups, norm.eps, act)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """diffusers ``FeedForward(activation_fn="geglu")``: net.0 = GEGLU
    (dim -> 2 x 4dim, gated), net.1 = dropout (no parameters), net.2 =
    Linear(4dim -> dim).

    ``chunk_tokens > 0`` runs it over token chunks of that length, each
    recomputed in the backward, so the (B, L, 8 dim) GEGLU activation never
    exists beyond one chunk; the numbers are those of the unchunked path
    (the feed-forward is pointwise over tokens)."""

    def __init__(self, dim: int, mult: int = 4, chunk_tokens: int = 0):
        super().__init__()
        self.chunk_tokens = chunk_tokens
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def _core(self, x):
        for layer in self.net:
            x = layer(x)
        return x

    def forward(self, x):
        ct = self.chunk_tokens
        if not ct or x.shape[1] <= ct:
            return self._core(x)
        return torch.cat([checkpointed(True, self._core, xc) for xc in x.split(ct, dim=1)],
                         dim=1)


class ResnetBlock(nn.Module):
    """SD resnet block: GN-SiLU-conv, time-embedding inject, GN-SiLU-conv, +skip."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int], groups: int, eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels else None)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None):
        h = self.conv1(gn(self.norm1, x, "silu"))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(gn(self.norm2, h, "silu"))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    """Stride-2 3x3 conv, padding 1 (the SD1.5 UNet convention)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return nearest_up2_conv3x3(x, self.conv.weight, self.conv.bias)


class TransformerBlock(nn.Module):
    """Spatial transformer block (self-attn, cross-attn, FF).

    Returns ``(x, norm1)``: the pre-self-attention LayerNorm output is the
    ReferenceNet's bank feature. As the video UNet's block it appends
    ``ref_feature`` to the self-attention keys/values, hidden from the
    ``ref_disable`` rows.
    """

    def __init__(self, dim: int, heads: int, context_dim: int, ff_chunk_tokens: int = 0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = MultiHeadAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = MultiHeadAttention(dim, heads, context_dim=context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, chunk_tokens=ff_chunk_tokens)

    def forward(self, x, context, ref_feature=None, ref_disable=None):
        norm1 = self.norm1(x)
        x = x + self.attn1(norm1, extra_kv=ref_feature, extra_kv_disable=ref_disable)
        x = x + self.attn2(self.norm2(x), context=context)
        x = x + self.ff(self.norm3(x))
        return x, norm1


class SpatialTransformer(nn.Module):
    """Transformer2D/3D: GN + 1x1-conv proj in/out around the transformer
    blocks, on ``((b f), c, h, w)``; the CLIP context, the reference feature
    and ``ref_disable`` are repeated per frame."""

    def __init__(self, dim: int, heads: int, context_dim: int, groups: int,
                 depth: int = 1, norm_eps: float = 1e-6, ff_chunk_tokens: int = 0):
        super().__init__()
        self.norm = nn.GroupNorm(groups, dim, norm_eps)
        self.proj_in = nn.Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(dim, heads, context_dim, ff_chunk_tokens) for _ in range(depth)])
        self.proj_out = nn.Conv2d(dim, dim, 1)

    def forward(self, x, context, frames: int = 1, ref_feature=None,
                ref_disable=None) -> Tuple[torch.Tensor, torch.Tensor]:
        bf, _, h, w = x.shape
        residual = x
        tokens = to_tokens(self.proj_in(gn(self.norm, x)))

        def per_frame(t):
            if t is None or t.shape[0] == bf:
                return t
            return t.repeat_interleave(frames, dim=0)

        context, ref_feature, ref_disable = map(
            per_frame, (context, ref_feature, ref_disable))
        banks = []
        for block in self.transformer_blocks:
            tokens, norm1 = block(tokens, context, ref_feature, ref_disable)
            banks.append(norm1)
        x = self.proj_out(from_tokens(tokens, h, w))
        return x + residual, banks[0]


class TemporalTransformerBlock(nn.Module):
    """N x (LN -> +PE -> frame-axis self-attn -> +res), then LN -> FF -> +res,
    on tokens ``((b f), l, c)``. Shared by the AnimateDiff motion module
    (2 attentions) and the CameraCtrl camera encoder (1 attention). The
    sinusoidal position encoding is added to the attention input, so it
    shapes q, k and v."""

    def __init__(self, dim: int, heads: int, num_attention_blocks: int = 2,
                 max_len: int = 32, use_pe: bool = True, ff_chunk_tokens: int = 0):
        super().__init__()
        self.max_len = max_len
        self.use_pe = use_pe
        self.attention_blocks = nn.ModuleList(
            [MultiHeadAttention(dim, heads)
             for _ in range(num_attention_blocks)])
        self.norms = nn.ModuleList(
            [nn.LayerNorm(dim, eps=1e-5) for _ in range(num_attention_blocks)])
        self.ff = FeedForward(dim, chunk_tokens=ff_chunk_tokens)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, frames: int) -> torch.Tensor:
        bf, l, c = x.shape
        pe = None
        if self.use_pe:
            if frames > self.max_len:
                raise ValueError(f"{frames} frames > position table length {self.max_len}")
            pe = sinusoidal_positional_encoding(self.max_len, c, device=x.device)
            pe = pe[:frames].to(x.dtype)[None, :, None, :]
        for attn, norm in zip(self.attention_blocks, self.norms):
            n = norm(x)
            if pe is not None:
                n = (n.reshape(bf // frames, frames, l, c) + pe).reshape(bf, l, c)
            x = x + attn(n, temporal_frames=frames)
        return x + self.ff(self.ff_norm(x))


class TemporalTransformer(nn.Module):
    """AnimateDiff TemporalTransformer3DModel: GN -> linear proj_in ->
    temporal blocks -> zero-init linear proj_out -> +residual."""

    def __init__(self, dim: int, heads: int = 8, depth: int = 1,
                 attention_blocks_per_layer: int = 2, max_len: int = 32,
                 use_pe: bool = True, norm_eps: float = 1e-6, ff_chunk_tokens: int = 0):
        super().__init__()
        self.norm = nn.GroupNorm(32, dim, norm_eps)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList([
            TemporalTransformerBlock(dim, heads, attention_blocks_per_layer,
                                     max_len, use_pe, ff_chunk_tokens)
            for _ in range(depth)])
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, frames: int) -> torch.Tensor:
        _, _, h, w = x.shape
        tokens = self.proj_in(to_tokens(gn(self.norm, x)))
        for block in self.transformer_blocks:
            tokens = block(tokens, frames)
        return x + from_tokens(self.proj_out(tokens), h, w)


class MotionModule(nn.Module):
    """AnimateDiff VanillaTemporalModule: holds ``temporal_transformer``."""

    def __init__(self, dim: int, **kw):
        super().__init__()
        self.temporal_transformer = TemporalTransformer(dim, **kw)

    def forward(self, x, frames: int):
        return self.temporal_transformer(x, frames)
