"""The published SwinIR forward, for the tests: an ``nn.Module`` in the
released key layout, in plain PyTorch and float32.

Liang et al., "SwinIR: Image Restoration Using Swin Transformer",
arXiv:2108.10257; github.com/JingyunLiang/SwinIR ``models/network_swinir.py``.
The classes below follow that file's: the Swin transformer layer (window
attention with a learned relative-position bias, a cyclic shift of half a
window in every second layer with the -100 mask between the regions the
wrap-around joins, the MLP), the residual Swin group (RSTB), the reflect
padding to a multiple of the window (``check_image_size``), the mean shift
and the four upsamplers.  Dropout and stochastic depth are left out: this
is the module in ``eval()``.  It imports neither JAX nor the port, and the
test modules use it under ``true_fp32`` (no TF32).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as TF


class Mlp(nn.Module):
    def __init__(self, in_features, hidden_features):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden_features, in_features)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


def window_partition(x, window_size):
    """(B, H, W, C) -> (num_windows * B, window_size, window_size, C)."""
    B, H, W, C = x.shape
    x = x.view(B, H // window_size, window_size, W // window_size, window_size, C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window_size, window_size, C)


def window_reverse(windows, window_size, H, W):
    """(num_windows * B, window_size, window_size, C) -> (B, H, W, C)."""
    B = int(windows.shape[0] / (H * W / window_size / window_size))
    x = windows.view(B, H // window_size, W // window_size, window_size, window_size, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, H, W, -1)


def relative_position_index(window_size: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid([torch.arange(window_size), torch.arange(window_size)],
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window_size - 1
    rel[:, :, 1] += window_size - 1
    rel[:, :, 0] *= 2 * window_size - 1
    return rel.sum(-1)


class WindowAttention(nn.Module):
    def __init__(self, dim, window_size, num_heads):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", relative_position_index(window_size))
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        nn.init.trunc_normal_(self.relative_position_bias_table, std=.02)

    def forward(self, x, mask=None):
        B_, N, C = x.shape
        qkv = self.qkv(x).reshape(B_, N, 3, self.num_heads, C // self.num_heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * self.scale
        attn = q @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[self.relative_position_index.view(-1)]
        bias = bias.view(N, N, -1)
        attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.view(B_ // nW, nW, self.num_heads, N, N) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.num_heads, N, N)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(x)


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim, input_resolution, num_heads, window_size=7, shift_size=0,
                 mlp_ratio=4.):
        super().__init__()
        self.dim, self.input_resolution, self.num_heads = dim, input_resolution, num_heads
        self.window_size, self.shift_size = window_size, shift_size
        if min(self.input_resolution) <= self.window_size:
            self.shift_size = 0
            self.window_size = min(self.input_resolution)
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, self.window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        attn_mask = self.calculate_mask(self.input_resolution) if self.shift_size > 0 else None
        self.register_buffer("attn_mask", attn_mask)

    def calculate_mask(self, x_size):
        H, W = x_size
        img_mask = torch.zeros((1, H, W, 1))
        slices = (slice(0, -self.window_size), slice(-self.window_size, -self.shift_size),
                  slice(-self.shift_size, None))
        cnt = 0
        for h in slices:
            for w in slices:
                img_mask[:, h, w, :] = cnt
                cnt += 1
        mask_windows = window_partition(img_mask, self.window_size).view(
            -1, self.window_size * self.window_size)
        attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
        return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(
            attn_mask == 0, float(0.0))

    def forward(self, x, x_size):
        H, W = x_size
        B, L, C = x.shape
        shortcut = x
        x = self.norm1(x).view(B, H, W, C)
        if self.shift_size > 0:
            x = torch.roll(x, shifts=(-self.shift_size, -self.shift_size), dims=(1, 2))
        x_windows = window_partition(x, self.window_size).view(-1, self.window_size ** 2, C)
        if self.input_resolution == x_size:
            attn_windows = self.attn(x_windows, mask=self.attn_mask)
        else:
            mask = self.calculate_mask(x_size).to(x.device) if self.shift_size > 0 else None
            attn_windows = self.attn(x_windows, mask=mask)
        attn_windows = attn_windows.view(-1, self.window_size, self.window_size, C)
        x = window_reverse(attn_windows, self.window_size, H, W)
        if self.shift_size > 0:
            x = torch.roll(x, shifts=(self.shift_size, self.shift_size), dims=(1, 2))
        x = shortcut + x.view(B, H * W, C)
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    def __init__(self, dim, input_resolution, depth, num_heads, window_size, mlp_ratio):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, input_resolution, num_heads, window_size,
                                 0 if i % 2 == 0 else window_size // 2, mlp_ratio)
            for i in range(depth)])

    def forward(self, x, x_size):
        for blk in self.blocks:
            x = blk(x, x_size)
        return x


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim, norm):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dim) if norm else None

    def forward(self, x):
        x = x.flatten(2).transpose(1, 2)
        return self.norm(x) if self.norm is not None else x


def patch_unembed(x, x_size):
    B, HW, C = x.shape
    return x.transpose(1, 2).view(B, C, x_size[0], x_size[1])


class RSTB(nn.Module):
    def __init__(self, dim, input_resolution, depth, num_heads, window_size, mlp_ratio,
                 resi_connection="1conv"):
        super().__init__()
        self.residual_group = BasicLayer(dim, input_resolution, depth, num_heads, window_size,
                                         mlp_ratio)
        if resi_connection == "1conv":
            self.conv = nn.Conv2d(dim, dim, 3, 1, 1)
        elif resi_connection == "3conv":
            self.conv = nn.Sequential(
                nn.Conv2d(dim, dim // 4, 3, 1, 1), nn.LeakyReLU(negative_slope=0.2, inplace=True),
                nn.Conv2d(dim // 4, dim // 4, 1, 1, 0),
                nn.LeakyReLU(negative_slope=0.2, inplace=True),
                nn.Conv2d(dim // 4, dim, 3, 1, 1))
        self.patch_embed = PatchEmbed(dim, norm=False)

    def forward(self, x, x_size):
        y = patch_unembed(self.residual_group(x, x_size), x_size)
        return self.patch_embed(self.conv(y)) + x


class Upsample(nn.Sequential):
    def __init__(self, scale, num_feat):
        m = []
        if (scale & (scale - 1)) == 0:
            for _ in range(int(math.log(scale, 2))):
                m += [nn.Conv2d(num_feat, 4 * num_feat, 3, 1, 1), nn.PixelShuffle(2)]
        elif scale == 3:
            m += [nn.Conv2d(num_feat, 9 * num_feat, 3, 1, 1), nn.PixelShuffle(3)]
        super().__init__(*m)


class UpsampleOneStep(nn.Sequential):
    def __init__(self, scale, num_feat, num_out_ch):
        super().__init__(nn.Conv2d(num_feat, (scale ** 2) * num_out_ch, 3, 1, 1),
                         nn.PixelShuffle(scale))


class SwinIR(nn.Module):
    """``SwinIR(upscale=4, in_chans=3, img_size=64, window_size=8,
    img_range=1., depths=[6]*6, embed_dim=180, num_heads=[6]*6, mlp_ratio=2,
    upsampler='nearest+conv', resi_connection='1conv')`` is the released
    real-world x4 model M."""

    def __init__(self, img_size=64, in_chans=3, embed_dim=96, depths=(6, 6, 6, 6),
                 num_heads=(6, 6, 6, 6), window_size=7, mlp_ratio=4., upscale=2, img_range=1.,
                 upsampler="", resi_connection="1conv"):
        super().__init__()
        num_out_ch, num_feat = in_chans, 64
        self.img_range = img_range
        self.mean = (torch.Tensor((0.4488, 0.4371, 0.4040)).view(1, 3, 1, 1) if in_chans == 3
                     else torch.zeros(1, 1, 1, 1))
        self.upscale, self.upsampler, self.window_size = upscale, upsampler, window_size
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbed(embed_dim, norm=True)
        res = (img_size, img_size)
        self.layers = nn.ModuleList([
            RSTB(embed_dim, res, depths[i], num_heads[i], window_size, mlp_ratio, resi_connection)
            for i in range(len(depths))])
        self.norm = nn.LayerNorm(embed_dim)
        if resi_connection == "1conv":
            self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)
        elif resi_connection == "3conv":
            self.conv_after_body = nn.Sequential(
                nn.Conv2d(embed_dim, embed_dim // 4, 3, 1, 1),
                nn.LeakyReLU(negative_slope=0.2, inplace=True),
                nn.Conv2d(embed_dim // 4, embed_dim // 4, 1, 1, 0),
                nn.LeakyReLU(negative_slope=0.2, inplace=True),
                nn.Conv2d(embed_dim // 4, embed_dim, 3, 1, 1))
        if upsampler == "pixelshuffle":
            self.conv_before_upsample = nn.Sequential(nn.Conv2d(embed_dim, num_feat, 3, 1, 1),
                                                      nn.LeakyReLU(inplace=True))
            self.upsample = Upsample(upscale, num_feat)
            self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)
        elif upsampler == "pixelshuffledirect":
            self.upsample = UpsampleOneStep(upscale, embed_dim, num_out_ch)
        elif upsampler == "nearest+conv":
            assert upscale == 4, "only support x4 now."
            self.conv_before_upsample = nn.Sequential(nn.Conv2d(embed_dim, num_feat, 3, 1, 1),
                                                      nn.LeakyReLU(inplace=True))
            self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
            self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)
            self.lrelu = nn.LeakyReLU(negative_slope=0.2, inplace=True)
        else:
            self.conv_last = nn.Conv2d(embed_dim, num_out_ch, 3, 1, 1)

    def check_image_size(self, x):
        _, _, h, w = x.size()
        mod_pad_h = (self.window_size - h % self.window_size) % self.window_size
        mod_pad_w = (self.window_size - w % self.window_size) % self.window_size
        return TF.pad(x, (0, mod_pad_w, 0, mod_pad_h), "reflect")

    def forward_features(self, x):
        x_size = (x.shape[2], x.shape[3])
        x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x, x_size)
        return patch_unembed(self.norm(x), x_size)

    def forward(self, x):
        H, W = x.shape[2:]
        x = self.check_image_size(x)
        mean = self.mean.type_as(x)
        x = (x - mean) * self.img_range
        if self.upsampler == "pixelshuffle":
            x = self.conv_first(x)
            x = self.conv_after_body(self.forward_features(x)) + x
            x = self.conv_last(self.upsample(self.conv_before_upsample(x)))
        elif self.upsampler == "pixelshuffledirect":
            x = self.conv_first(x)
            x = self.upsample(self.conv_after_body(self.forward_features(x)) + x)
        elif self.upsampler == "nearest+conv":
            x = self.conv_first(x)
            x = self.conv_after_body(self.forward_features(x)) + x
            x = self.conv_before_upsample(x)
            x = self.lrelu(self.conv_up1(TF.interpolate(x, scale_factor=2, mode="nearest")))
            x = self.lrelu(self.conv_up2(TF.interpolate(x, scale_factor=2, mode="nearest")))
            x = self.conv_last(self.lrelu(self.conv_hr(x)))
        else:
            x_first = self.conv_first(x)
            res = self.conv_after_body(self.forward_features(x_first)) + x_first
            x = x + self.conv_last(res)
        x = x / self.img_range + mean
        return x[:, :, :H * self.upscale, :W * self.upscale]


def seeded(model: SwinIR, seed: int, *, bias_std: float = 1.0) -> SwinIR:
    """``model`` with seeded weights that make each part of the block show:
    linears and convs at unit gain, LayerNorm affines spread about (1, 0),
    the relative-position tables with std ``bias_std`` (the published init,
    0.02, would hide them in any tolerance), and every bias spread by 0.02."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if name.endswith("relative_position_bias_table"):
                p.copy_(r * bias_std)
            elif p.dim() > 1:
                p.copy_(r / math.sqrt(p[0].numel()))
            elif ".norm" in name or name.startswith("norm."):
                p.copy_(1.0 + 0.1 * r if name.endswith("weight") else 0.1 * r)
            else:
                p.copy_(0.02 * r)
    return model.eval()
