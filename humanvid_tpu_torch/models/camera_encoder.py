"""CameraPoseEncoder: Plücker-ray video -> 1/8-resolution conditioning feature.

The CameraCtrl pose adaptor at the shipped operating point:

    PixelUnshuffle(8) (6 -> 384 ch) -> 3x3 conv 384->320 ->
    nums_rb x [ T2I-adapter resnet (3x3 conv -> ReLU -> ksize conv, +skip)
                -> TemporalTransformerBlock (1x frame-axis self-attention
                   + FF, sinusoidal position encoding; kernel B) ]
    -> zero-init 1x1 conv (no bias)

The output is added to the PoseGuider feature before the video UNet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import pixel_unshuffle
from .configs import CameraEncoderConfig
from .layers import TemporalTransformerBlock, from_tokens, to_tokens


class AdapterResnetBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, ksize: int = 1):
        super().__init__()
        self.block1 = nn.Conv2d(in_channels, channels, 3, padding=1)
        self.block2 = nn.Conv2d(channels, channels, ksize, padding=ksize // 2)

    def forward(self, x):
        return x + self.block2(F.relu(self.block1(x)))


class CameraPoseEncoder(nn.Module):
    def __init__(self, config: CameraEncoderConfig = CameraEncoderConfig()):
        super().__init__()
        cfg = self.config = config
        self.encoder_conv_in = nn.Conv2d(cfg.cin, cfg.channels[0], 3, padding=1)
        convs, attns, zeros = [], [], []
        prev = cfg.channels[0]
        for ch in cfg.channels:
            convs.append(nn.ModuleList(
                [AdapterResnetBlock(prev if j == 0 else ch, ch, cfg.ksize)
                 for j in range(cfg.nums_rb)]))
            attns.append(nn.ModuleList(
                [TemporalTransformerBlock(
                    ch, cfg.num_heads, len(cfg.attention_block_types),
                    cfg.position_encoding_max_len, cfg.position_encoding,
                    cfg.ff_chunk_tokens)
                 for _ in range(cfg.nums_rb)]))
            zeros.append(nn.Conv2d(ch, ch, 1, bias=False))
            prev = ch
        self.encoder_down_conv_blocks = nn.ModuleList(convs)
        self.encoder_down_attention_blocks = nn.ModuleList(attns)
        self.zero_conv_layers = nn.ModuleList(zeros)

    def forward(self, plucker: torch.Tensor, frames: int) -> torch.Tensor:
        """plucker ((b f), 6, H, W) -> feature ((b f), 320, H/8, W/8)."""
        x = self.encoder_conv_in(pixel_unshuffle(plucker, self.config.downscale_factor))
        for i, (convs, attns, zero) in enumerate(zip(
                self.encoder_down_conv_blocks, self.encoder_down_attention_blocks,
                self.zero_conv_layers)):
            for j, (res, attn) in enumerate(zip(convs, attns)):
                if i > 0 and j == 0:
                    x = F.avg_pool2d(x, 2)
                x = res(x)
                h, w = x.shape[2:]
                x = from_tokens(attn(to_tokens(x), frames), h, w)
            x = zero(x)
        return x
