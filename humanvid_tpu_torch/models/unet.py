"""The conditional diffusion UNet, in both of its roles.

- **ReferenceNet** (``UNetConditionModel(SD15_UNET)``, ``frames=1``,
  ``collect_ref_features=True``): the SD1.5 2D UNet on the reference-image
  latent; returns the pre-self-attention LayerNorm output of each of its
  transformer blocks in forward order (down -> mid -> up).
- **Video UNet** (``SD15_VIDEO_UNET``): the same backbone run on
  ``((b f), c, h, w)``, AnimateDiff motion modules after every spatial stage,
  ``cond_fea`` (pose guider + camera features) added after ``conv_in``, and
  the reference features consumed in the same forward order as extra
  self-attention keys/values.

Parameter names are the diffusers ``UNet2DConditionModel`` / AnimateDiff
``UNet3DConditionModel`` state-dict keys. With ``gradient_checkpointing``
each resnet, spatial transformer and motion module is recomputed in the
backward; ``ff_chunk_tokens`` reaches every feed-forward.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.embeddings import sinusoidal_timestep_embedding
from .configs import UNetConfig
from .layers import (
    Downsample,
    MotionModule,
    ResnetBlock,
    SpatialTransformer,
    Upsample,
    checkpointed,
    gn,
)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _Block(nn.Module):
    """One down, mid or up block: resnets, optional spatial transformers and
    motion modules (one of each per resnet), optional resampler."""

    def __init__(self, resnets, attentions=None, motion_modules=None,
                 downsample: Optional[int] = None, upsample: Optional[int] = None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if motion_modules:
            self.motion_modules = nn.ModuleList(motion_modules)
        if downsample:
            self.downsamplers = nn.ModuleList([Downsample(downsample)])
        if upsample:
            self.upsamplers = nn.ModuleList([Upsample(upsample)])


class UNetConditionModel(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        chans = cfg.block_out_channels
        ted = cfg.time_embed_dim
        n = len(chans)

        def resnet(cin, cout):
            return ResnetBlock(cin, cout, ted, cfg.norm_num_groups, cfg.norm_eps)

        def spatial(ch):
            return SpatialTransformer(ch, cfg.attention_heads, cfg.cross_attention_dim,
                                      cfg.norm_num_groups, cfg.transformer_layers,
                                      ff_chunk_tokens=cfg.ff_chunk_tokens)

        def motion(ch):
            return MotionModule(
                ch, heads=cfg.motion_num_heads, depth=cfg.motion_transformer_blocks,
                attention_blocks_per_layer=len(cfg.motion_attention_types),
                max_len=cfg.motion_max_len, use_pe=cfg.motion_position_encoding,
                ff_chunk_tokens=cfg.ff_chunk_tokens)

        self.time_embedding = TimestepEmbedding(chans[0], ted)
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)

        skip_channels = [chans[0]]
        down = []
        cur = chans[0]
        for i, btype in enumerate(cfg.down_block_types):
            ch = chans[i]
            has_attn = btype == "CrossAttnDownBlock"
            resnets, attns, motions = [], [], []
            for j in range(cfg.layers_per_block):
                resnets.append(resnet(cur, ch))
                cur = ch
                if has_attn:
                    attns.append(spatial(ch))
                if cfg.use_motion_module:
                    motions.append(motion(ch))
                skip_channels.append(ch)
            last = i == n - 1
            if not last:
                skip_channels.append(ch)
            down.append(_Block(resnets, attns, motions,
                               downsample=None if last else ch))
        self.down_blocks = nn.ModuleList(down)

        mid_ch = chans[-1]
        self.mid_block = _Block(
            [resnet(mid_ch, mid_ch), resnet(mid_ch, mid_ch)], [spatial(mid_ch)],
            [motion(mid_ch)] if cfg.use_motion_module and cfg.motion_mid_block else None)

        up = []
        rev = list(reversed(chans))
        for i, btype in enumerate(cfg.up_block_types):
            ch = rev[i]
            has_attn = btype == "CrossAttnUpBlock"
            resnets, attns, motions = [], [], []
            for j in range(cfg.layers_per_block + 1):
                resnets.append(resnet(cur + skip_channels.pop(), ch))
                cur = ch
                if has_attn:
                    attns.append(spatial(ch))
                if cfg.use_motion_module:
                    motions.append(motion(ch))
            up.append(_Block(resnets, attns, motions,
                             upsample=ch if i < n - 1 else None))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, chans[0], cfg.norm_eps)
        self.conv_out = nn.Conv2d(chans[0], cfg.out_channels, 3, padding=1)

    @property
    def num_ref_features(self) -> int:
        cfg = self.config
        n = sum(cfg.layers_per_block for t in cfg.down_block_types
                if t == "CrossAttnDownBlock")
        n += 1
        n += sum(cfg.layers_per_block + 1 for t in cfg.up_block_types
                 if t == "CrossAttnUpBlock")
        return n

    def forward(
        self,
        sample: torch.Tensor,                      # ((b f), in_channels, h, w)
        timesteps: torch.Tensor,                   # (b,) or scalar
        context: torch.Tensor,                     # (b, 1, cross_attention_dim)
        cond_fea: Optional[torch.Tensor] = None,   # ((b f), c0, h, w)
        ref_features: Optional[Sequence[torch.Tensor]] = None,
        ref_disable: Optional[torch.Tensor] = None,  # (b,) bool, CFG uncond rows
        frames: int = 1,
        collect_ref_features: bool = False,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        cfg = self.config
        b = context.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device).reshape(-1)
        if timesteps.shape[0] == 1 and b > 1:
            timesteps = timesteps.expand(b)

        temb = sinusoidal_timestep_embedding(
            timesteps, cfg.block_out_channels[0],
            flip_sin_to_cos=cfg.flip_sin_to_cos,
            downscale_freq_shift=cfg.freq_shift).to(sample.dtype)
        temb = self.time_embedding(temb)
        if frames > 1:
            temb = temb.repeat_interleave(frames, dim=0)

        collected: List[torch.Tensor] = []
        ref_iter = iter(ref_features) if ref_features is not None else None
        ckpt = cfg.gradient_checkpointing

        def run_resnet(res, x):
            return checkpointed(ckpt, res, x, temb)

        def run_motion(mm, x):
            return checkpointed(ckpt, mm, x, frames)

        def run_spatial(st, x):
            ref_in = next(ref_iter) if ref_iter is not None else None
            x, bank = checkpointed(ckpt, st, x, context, frames, ref_in, ref_disable)
            if collect_ref_features:
                collected.append(bank)
            return x

        def run_block(block, x, skips=None):
            attns = getattr(block, "attentions", None)
            motions = getattr(block, "motion_modules", None)
            for j, res in enumerate(block.resnets):
                if skips is not None:
                    x = torch.cat([x, skips.pop()], dim=1)
                x = run_resnet(res, x)
                if attns is not None:
                    x = run_spatial(attns[j], x)
                if motions is not None:
                    x = run_motion(motions[j], x)
                if skips is None and block is not self.mid_block:
                    res_stack.append(x)
            return x

        sample = self.conv_in(sample)
        if cond_fea is not None:
            sample = sample + cond_fea.to(sample.dtype)

        res_stack = [sample]
        for block in self.down_blocks:
            sample = run_block(block, sample)
            if hasattr(block, "downsamplers"):
                sample = block.downsamplers[0](sample)
                res_stack.append(sample)

        mid = self.mid_block
        sample = run_resnet(mid.resnets[0], sample)
        sample = run_spatial(mid.attentions[0], sample)
        if hasattr(mid, "motion_modules"):
            sample = run_motion(mid.motion_modules[0], sample)
        sample = run_resnet(mid.resnets[1], sample)

        for block in self.up_blocks:
            sample = run_block(block, sample, skips=res_stack)
            if hasattr(block, "upsamplers"):
                sample = block.upsamplers[0](sample)

        sample = self.conv_out(gn(self.conv_norm_out, sample, "silu"))
        if ref_iter is not None and next(ref_iter, None) is not None:
            raise ValueError("more reference features than transformer blocks")
        return sample, tuple(collected)
