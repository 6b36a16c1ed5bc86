"""SD VAE (diffusers AutoencoderKL, sd-vae-ft-mse operating point): encoder,
decoder, and the diagonal Gaussian's mean and samples.

The mid-block attention is one head over all channels (d = 512 at the
published widths) with q/k/v biases; at 768x512 it runs over 6144 tokens and
routes to kernel A.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import MultiHeadAttention
from .configs import VAEConfig
from .layers import Upsample, from_tokens, gn, to_tokens


class VAEResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, 1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_channels, 1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(gn(self.norm1, x, "silu"))
        h = self.conv2(gn(self.norm2, h, "silu"))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(MultiHeadAttention):
    """GroupNorm + single-head self-attention with q/k/v biases, +residual."""

    def __init__(self, channels: int, groups: int):
        super().__init__(channels, 1, qkv_bias=True)
        self.group_norm = nn.GroupNorm(groups, channels, 1e-6)

    def forward(self, x):
        h, w = x.shape[2:]
        out = super().forward(to_tokens(gn(self.group_norm, x)))
        return x + from_tokens(out, h, w)


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(ch, ch, groups), VAEResnet(ch, ch, groups)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _VAEDownsample(nn.Module):
    """Stride-2 3x3 conv after an asymmetric (0, 1) zero pad."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Stage(nn.Module):
    def __init__(self, resnets, down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if down:
            self.downsamplers = nn.ModuleList([_VAEDownsample(down)])
        if up:
            self.upsamplers = nn.ModuleList([Upsample(up)])

    def forward(self, x):
        for res in self.resnets:
            x = res(x)
        for sampler in (getattr(self, "downsamplers", None)
                        or getattr(self, "upsamplers", None) or ()):
            x = sampler(x)
        return x


class _Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        stages, prev = [], chans[0]
        for i, ch in enumerate(chans):
            stages.append(_Stage(
                [VAEResnet(prev if j == 0 else ch, ch, g)
                 for j in range(cfg.layers_per_block)],
                down=ch if i < len(chans) - 1 else None))
            prev = ch
        self.down_blocks = nn.ModuleList(stages)
        self.mid_block = _MidBlock(chans[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, chans[-1], 1e-6)
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for stage in self.down_blocks:
            x = stage(x)
        x = self.mid_block(x)
        return self.conv_out(gn(self.conv_norm_out, x, "silu"))


class _Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0], g)
        stages, prev = [], rev[0]
        for i, ch in enumerate(rev):
            stages.append(_Stage(
                [VAEResnet(prev if j == 0 else ch, ch, g)
                 for j in range(cfg.layers_per_block + 1)],
                up=ch if i < len(rev) - 1 else None))
            prev = ch
        self.up_blocks = nn.ModuleList(stages)
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], 1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for stage in self.up_blocks:
            x = stage(x)
        return self.conv_out(gn(self.conv_norm_out, x, "silu"))


class VAEEncoder(nn.Module):
    """(n, 3, H, W) -> moments (n, 2*latent_channels, H/8, W/8)."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = _Encoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels,
                                    2 * config.latent_channels, 1)

    def forward(self, x):
        return self.quant_conv(self.encoder(x))


class VAEDecoder(nn.Module):
    """(n, latent_channels, h, w) -> (n, 3, 8h, 8w)."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                         config.latent_channels, 1)
        self.decoder = _Decoder(config)

    def forward(self, z):
        return self.decoder(self.post_quant_conv(z))


def gaussian_mean(moments: torch.Tensor) -> torch.Tensor:
    """Mean of the diagonal Gaussian given NCHW encoder moments."""
    return moments[:, : moments.shape[1] // 2]


def gaussian_sample(moments: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """A sample of the diagonal Gaussian given NCHW encoder moments and a
    standard-normal draw ``eps`` of the mean's shape (log-variance clipped
    to [-30, 20])."""
    mean, logvar = moments.chunk(2, dim=1)
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    return mean + std * eps.to(mean.dtype)
