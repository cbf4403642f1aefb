"""Latent-diffusion UNet (Stable-Diffusion-style conv + GroupNorm +
self- and cross-attention) and its DDPM noise schedule.

Counterpart of ``paddle_tpu/models/unet_diffusion.py``: ``UNetConfig``
(with ``tiny``), ``timestep_embedding``, ``ResnetBlock2D``,
``_Attention``, ``TransformerBlock2D``, ``Downsample2D``,
``Upsample2D``, ``UNet2DConditionModel`` and ``DDPMScheduler``, with the
reference's parameter names (``down_blocks.0.conv1.weight``,
``down_attns.1.attn2.to_k.weight``, ...). NCHW at the module surface.
Modules are ``torch.nn``: Linear weights are torch's ``[out, in]``
(``convert.load_paddle_tpu_state`` transposes the reference's ``[in,
out]``); convolutions run ``nn.functional.conv2d`` (cuDNN's
deterministic algorithms on the card), GroupNorm the port's
``group_norm`` and LayerNorm fp32 statistics and affine with one
rounding, as the reference. The upsampler is a nearest 2x
``interpolate`` (repeats, no scatter in its gradient).

``_Attention`` keeps paddle's ``[B, S, H, D]`` layout into
``nn.functional.scaled_dot_product_attention`` (not causal): at a kernel
head dim (64 or 128: SDXL's 640 and 1280 channels over 10 heads) it runs
the flash kernels forward and backward, the cross-attention with the
context's length as Sk (77 for SDXL, not a multiple of the kernels' key
tile), others the plain composition.

``DDPMScheduler.add_noise`` is deterministic and matches the reference;
``step``'s noise comes from an explicit ``torch.Generator`` (or
``key_noise``), so sampled trajectories are held within the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..core.generator import make_generator
from ..core.place import resolve_device
from ..nn import functional as F
from ..nn.functional.conv import Conv2d
from ..nn.functional.norm import GroupNorm
from ..nn.initializer import paddle_default_init_
from .gpt import _LayerNorm

__all__ = ["UNetConfig", "UNet2DConditionModel", "DDPMScheduler",
           "timestep_embedding"]


@dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    sample_size: int = 32
    block_out_channels: Tuple[int, ...] = (128, 256, 512)
    layers_per_block: int = 2
    attention_levels: Tuple[bool, ...] = (False, True, True)
    num_attention_heads: int = 8
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    time_embed_mult: int = 4

    @staticmethod
    def tiny(**kw):
        base = dict(
            in_channels=4, out_channels=4, sample_size=8,
            block_out_channels=(32, 64), layers_per_block=1,
            attention_levels=(False, True), num_attention_heads=4,
            cross_attention_dim=32, norm_num_groups=8,
        )
        base.update(kw)
        return UNetConfig(**base)


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding [B, dim] in fp32: ``cos`` then ``sin``
    of ``t * exp(-log(10000) i / half)``."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(0, half, dtype=torch.float32, device=timesteps.device)
        * (-math.log(10000.0) / half))
    args = timesteps.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch, out_ch, temb_ch, groups, **factory):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, **factory)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1, **factory)
        self.time_emb_proj = nn.Linear(temb_ch, out_ch, **factory)
        self.norm2 = GroupNorm(groups, out_ch, **factory)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, **factory)
        self.shortcut = (Conv2d(in_ch, out_ch, 1, **factory)
                         if in_ch != out_ch else None)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class _Attention(nn.Module):
    """Multi-head attention over flattened spatial tokens; ``context=None``
    is self-attention."""

    def __init__(self, query_dim, context_dim, heads, **factory):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False, **factory)
        self.to_k = nn.Linear(context_dim, query_dim, bias=False, **factory)
        self.to_v = nn.Linear(context_dim, query_dim, bias=False, **factory)
        self.to_out = nn.Linear(query_dim, query_dim, **factory)

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, n, c = x.shape
        h, t = self.heads, ctx.shape[1]
        q = self.to_q(x).reshape(b, n, h, c // h)
        k = self.to_k(ctx).reshape(b, t, h, c // h)
        v = self.to_v(ctx).reshape(b, t, h, c // h)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=False)
        return self.to_out(out.reshape(b, n, c))


class TransformerBlock2D(nn.Module):
    """norm -> self-attn -> cross-attn -> GELU FFN over spatial tokens."""

    def __init__(self, channels, heads, context_dim, groups, **factory):
        super().__init__()
        self.norm = GroupNorm(groups, channels, **factory)
        self.proj_in = nn.Linear(channels, channels, **factory)
        self.norm1 = _LayerNorm(channels, **factory)
        self.attn1 = _Attention(channels, channels, heads, **factory)
        self.norm2 = _LayerNorm(channels, **factory)
        self.attn2 = _Attention(channels, context_dim, heads, **factory)
        self.norm3 = _LayerNorm(channels, **factory)
        self.ff1 = nn.Linear(channels, channels * 4, **factory)
        self.ff2 = nn.Linear(channels * 4, channels, **factory)
        self.proj_out = nn.Linear(channels, channels, **factory)

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        residual = x
        h = self.norm(x).reshape(b, c, hh * ww).transpose(1, 2)
        h = self.proj_in(h)
        h = h + self.attn1(self.norm1(h))
        h = h + self.attn2(self.norm2(h), context)
        h = h + self.ff2(F.gelu(self.ff1(self.norm3(h))))
        h = self.proj_out(h)
        return h.transpose(1, 2).reshape(b, c, hh, ww) + residual


class Downsample2D(nn.Module):
    def __init__(self, ch, **factory):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=1, **factory)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch, **factory):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1, **factory)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class UNet2DConditionModel(nn.Module):
    """Conditional denoising UNet: ``eps = f(latents, t,
    encoder_hidden_states)``. ``device=None`` builds on the card (and
    raises without one); parameters are fp32, drawn from ``seed`` with
    the reference's layer defaults (``nn.initializer``)."""

    def __init__(self, config: UNetConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        f = dict(device=dev)
        self.config = config
        chs = config.block_out_channels
        temb_ch = chs[0] * config.time_embed_mult
        g, heads = config.norm_num_groups, config.num_attention_heads
        xdim = config.cross_attention_dim

        self.time_mlp1 = nn.Linear(chs[0], temb_ch, **f)
        self.time_mlp2 = nn.Linear(temb_ch, temb_ch, **f)
        self.conv_in = Conv2d(config.in_channels, chs[0], 3, padding=1, **f)

        self.down_blocks = nn.ModuleList()
        self.down_attns = nn.ModuleList()
        self.downsamplers = nn.ModuleList()
        skip_chs = [chs[0]]
        in_ch = chs[0]
        for level, out_ch in enumerate(chs):
            for _ in range(config.layers_per_block):
                self.down_blocks.append(
                    ResnetBlock2D(in_ch, out_ch, temb_ch, g, **f))
                self.down_attns.append(
                    TransformerBlock2D(out_ch, heads, xdim, g, **f)
                    if config.attention_levels[level] else None)
                in_ch = out_ch
                skip_chs.append(in_ch)
            if level < len(chs) - 1:
                self.downsamplers.append(Downsample2D(in_ch, **f))
                skip_chs.append(in_ch)
            else:
                self.downsamplers.append(None)

        self.mid_block1 = ResnetBlock2D(in_ch, in_ch, temb_ch, g, **f)
        self.mid_attn = TransformerBlock2D(in_ch, heads, xdim, g, **f)
        self.mid_block2 = ResnetBlock2D(in_ch, in_ch, temb_ch, g, **f)

        self.up_blocks = nn.ModuleList()
        self.up_attns = nn.ModuleList()
        self.upsamplers = nn.ModuleList()
        for level, out_ch in reversed(list(enumerate(chs))):
            for _ in range(config.layers_per_block + 1):
                skip = skip_chs.pop()
                self.up_blocks.append(
                    ResnetBlock2D(in_ch + skip, out_ch, temb_ch, g, **f))
                self.up_attns.append(
                    TransformerBlock2D(out_ch, heads, xdim, g, **f)
                    if config.attention_levels[level] else None)
                in_ch = out_ch
            self.upsamplers.append(Upsample2D(in_ch, **f) if level > 0
                                   else None)

        self.norm_out = GroupNorm(g, chs[0], **f)
        self.conv_out = Conv2d(chs[0], config.out_channels, 3, padding=1,
                               **f)
        paddle_default_init_(self, make_generator(seed, dev))

    def forward(self, sample, timesteps, encoder_hidden_states):
        cfg = self.config
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        # the sinusoid is fp32; it follows the model's dtype into the MLP
        temb = temb.to(self.time_mlp1.weight.dtype)
        temb = self.time_mlp2(F.silu(self.time_mlp1(temb)))

        h = self.conv_in(sample)
        skips = [h]
        i = 0
        for level in range(len(cfg.block_out_channels)):
            for _ in range(cfg.layers_per_block):
                h = self.down_blocks[i](h, temb)
                if self.down_attns[i] is not None:
                    h = self.down_attns[i](h, encoder_hidden_states)
                skips.append(h)
                i += 1
            if self.downsamplers[level] is not None:
                h = self.downsamplers[level](h)
                skips.append(h)

        h = self.mid_block1(h, temb)
        h = self.mid_attn(h, encoder_hidden_states)
        h = self.mid_block2(h, temb)

        i = 0
        for idx in range(len(cfg.block_out_channels)):
            for _ in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = self.up_blocks[i](h, temb)
                if self.up_attns[i] is not None:
                    h = self.up_attns[i](h, encoder_hidden_states)
                i += 1
            if self.upsamplers[idx] is not None:
                h = self.upsamplers[idx](h)

        return self.conv_out(F.silu(self.norm_out(h)))

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())


class DDPMScheduler:
    """DDPM noise schedule (linear betas, fp64 products stored in fp32):
    ``add_noise`` for training, ``step`` for ancestral sampling."""

    def __init__(self, num_train_timesteps=1000, beta_start=1e-4,
                 beta_end=0.02):
        self.num_train_timesteps = num_train_timesteps
        betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                            dtype="float64")
        self._betas = betas.astype("float32")
        self._alphas_cumprod = np.cumprod(1.0 - betas).astype("float32")
        self._tables = {}

    def _alphas(self, device):
        """The schedule on ``device``, uploaded once."""
        if device not in self._tables:
            self._tables[device] = torch.from_numpy(
                self._alphas_cumprod).to(device)
        return self._tables[device]

    def add_noise(self, clean, noise, timesteps):
        """``sqrt(a_t) clean + sqrt(1 - a_t) noise`` per row, ``a_t`` the
        cumulative product at each row's timestep (fp32, so half inputs
        give fp32, as in the reference)."""
        a = self._alphas(clean.device)[timesteps.long()].reshape(-1, 1, 1, 1)
        return torch.sqrt(a) * clean + torch.sqrt(1.0 - a) * noise

    def step(self, eps_pred, t: int, sample, key_noise=None, generator=None):
        """One ancestral step from timestep ``t``: the posterior mean, plus
        ``sqrt(beta_t)`` times noise for ``t > 0`` (``key_noise`` as given,
        else drawn from ``generator``, a ``torch.Generator`` on the
        sample's device)."""
        beta = float(self._betas[t])
        alpha = 1.0 - beta
        ac = float(self._alphas_cumprod[t])
        coef = beta / math.sqrt(1.0 - ac)
        mean = (sample - coef * eps_pred) / math.sqrt(alpha)
        if t == 0:
            return mean
        noise = key_noise
        if noise is None:
            if generator is None:
                raise ValueError("DDPMScheduler.step draws noise for t > 0: "
                                 "pass key_noise= or generator=")
            noise = torch.randn(sample.shape, generator=generator,
                                dtype=sample.dtype, device=sample.device)
        return mean + math.sqrt(beta) * noise
