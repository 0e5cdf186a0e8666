"""The published HAT forward, for the tests: an ``nn.Module`` in the released
key layout, in plain PyTorch and float32.

Chen et al., "Activating More Pixels in Image Super-Resolution
Transformer", arXiv:2205.04437; github.com/XPixelGroup/HAT
``hat/archs/hat_arch.py``.  The classes below follow that file's: the
channel attention and the CAB (conv, GELU, conv, the squeeze-and-excite
gate over ``nn.AdaptiveAvgPool2d(1)``), the window attention (the table
read through the index the model passes in, negative rows wrapped by
PyTorch's indexing), the hybrid attention block (the CAB on LN1's output
beside the shifted-window attention, ``x + attn_x + conv_scale conv_x``),
the overlapping cross-attention block (q in 16 x 16 windows, k and v
unfolded by ``nn.Unfold(24, stride 16, padding 4)`` after the linear), the
groups (RHAG), ``calculate_rpi_sa``, ``calculate_rpi_oca``,
``calculate_mask`` and the pixelshuffle upsampler, with the reflect padding
to a multiple of the window of ``hat_model.py::pre_process`` and its crop.
Dropout and stochastic depth are left out: this is the module in
``eval()``.  It departs from the published file nowhere else.  It imports
neither JAX nor the port, and sets TF32 off for the tests that use it.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as TF

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class ChannelAttention(nn.Module):
    def __init__(self, num_feat, squeeze_factor=16):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(num_feat, num_feat // squeeze_factor, 1, padding=0),
            nn.ReLU(inplace=True),
            nn.Conv2d(num_feat // squeeze_factor, num_feat, 1, padding=0),
            nn.Sigmoid())

    def forward(self, x):
        return x * self.attention(x)


class CAB(nn.Module):
    def __init__(self, num_feat, compress_ratio=3, squeeze_factor=30):
        super().__init__()
        self.cab = nn.Sequential(
            nn.Conv2d(num_feat, num_feat // compress_ratio, 3, 1, 1),
            nn.GELU(),
            nn.Conv2d(num_feat // compress_ratio, num_feat, 3, 1, 1),
            ChannelAttention(num_feat, squeeze_factor))

    def forward(self, x):
        return self.cab(x)


class Mlp(nn.Module):
    def __init__(self, in_features, hidden_features):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden_features, in_features)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


def window_partition(x, window_size):
    """(b, h, w, c) -> (num_windows * b, window_size, window_size, c)."""
    b, h, w, c = x.shape
    x = x.view(b, h // window_size, window_size, w // window_size, window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window_size, window_size, c)


def window_reverse(windows, window_size, h, w):
    """(num_windows * b, window_size, window_size, c) -> (b, h, w, c)."""
    b = int(windows.shape[0] / (h * w / window_size / window_size))
    x = windows.view(b, h // window_size, w // window_size, window_size, window_size, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


class WindowAttention(nn.Module):
    def __init__(self, dim, window_size, num_heads):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) * (2 * window_size - 1), num_heads))
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        nn.init.trunc_normal_(self.relative_position_bias_table, std=.02)
        self.softmax = nn.Softmax(dim=-1)

    def forward(self, x, rpi, mask=None):
        b_, n, c = x.shape
        qkv = self.qkv(x).reshape(b_, n, 3, self.num_heads, c // self.num_heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * self.scale
        attn = q @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[rpi.view(-1)].view(
            self.window_size * self.window_size, self.window_size * self.window_size, -1)
        attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b_ // nw, nw, self.num_heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.num_heads, n, n)
        attn = self.softmax(attn)
        x = (attn @ v).transpose(1, 2).reshape(b_, n, c)
        return self.proj(x)


class HAB(nn.Module):
    def __init__(self, dim, num_heads, window_size=7, shift_size=0, compress_ratio=3,
                 squeeze_factor=30, conv_scale=0.01, mlp_ratio=4.):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.conv_scale = conv_scale
        self.conv_block = CAB(dim, compress_ratio, squeeze_factor)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, x_size, rpi_sa, attn_mask):
        h, w = x_size
        b, _, c = x.shape
        shortcut = x
        x = self.norm1(x)
        x = x.view(b, h, w, c)
        conv_x = self.conv_block(x.permute(0, 3, 1, 2))
        conv_x = conv_x.permute(0, 2, 3, 1).contiguous().view(b, h * w, c)
        if self.shift_size > 0:
            shifted_x = torch.roll(x, shifts=(-self.shift_size, -self.shift_size), dims=(1, 2))
        else:
            shifted_x = x
            attn_mask = None
        x_windows = window_partition(shifted_x, self.window_size)
        x_windows = x_windows.view(-1, self.window_size * self.window_size, c)
        attn_windows = self.attn(x_windows, rpi=rpi_sa, mask=attn_mask)
        attn_windows = attn_windows.view(-1, self.window_size, self.window_size, c)
        shifted_x = window_reverse(attn_windows, self.window_size, h, w)
        if self.shift_size > 0:
            attn_x = torch.roll(shifted_x, shifts=(self.shift_size, self.shift_size), dims=(1, 2))
        else:
            attn_x = shifted_x
        attn_x = attn_x.view(b, h * w, c)
        x = shortcut + attn_x + conv_x * self.conv_scale
        return x + self.mlp(self.norm2(x))


class OCAB(nn.Module):
    def __init__(self, dim, window_size, overlap_ratio, num_heads, mlp_ratio=2):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.overlap_win_size = int(window_size * overlap_ratio) + window_size
        self.norm1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, dim * 3)
        self.unfold = nn.Unfold(kernel_size=(self.overlap_win_size, self.overlap_win_size),
                                stride=window_size,
                                padding=(self.overlap_win_size - window_size) // 2)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (window_size + self.overlap_win_size - 1) * (window_size + self.overlap_win_size - 1),
            num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=.02)
        self.softmax = nn.Softmax(dim=-1)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, x_size, rpi):
        h, w = x_size
        b, _, c = x.shape
        shortcut = x
        x = self.norm1(x)
        x = x.view(b, h, w, c)
        qkv = self.qkv(x).reshape(b, h, w, 3, c).permute(3, 0, 4, 1, 2)   # 3, b, c, h, w
        q = qkv[0].permute(0, 2, 3, 1)                                     # b, h, w, c
        kv = torch.cat((qkv[1], qkv[2]), dim=1)                           # b, 2 c, h, w
        q_windows = window_partition(q, self.window_size)
        q_windows = q_windows.view(-1, self.window_size * self.window_size, c)
        kv_windows = self.unfold(kv)                                       # b, c ow ow, nw
        # rearrange 'b (nc ch owh oww) nw -> nc (b nw) (owh oww) ch'
        ow = self.overlap_win_size
        nw = kv_windows.shape[-1]
        kv_windows = kv_windows.view(b, 2, c, ow, ow, nw).permute(1, 0, 5, 3, 4, 2)
        kv_windows = kv_windows.reshape(2, b * nw, ow * ow, c).contiguous()
        k_windows, v_windows = kv_windows[0], kv_windows[1]
        b_, nq, _ = q_windows.shape
        _, n, _ = k_windows.shape
        d = self.dim // self.num_heads
        q = q_windows.reshape(b_, nq, self.num_heads, d).permute(0, 2, 1, 3)
        k = k_windows.reshape(b_, n, self.num_heads, d).permute(0, 2, 1, 3)
        v = v_windows.reshape(b_, n, self.num_heads, d).permute(0, 2, 1, 3)
        q = q * self.scale
        attn = q @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[rpi.view(-1)].view(
            self.window_size * self.window_size, ow * ow, -1)
        attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
        attn = self.softmax(attn)
        attn_windows = (attn @ v).transpose(1, 2).reshape(b_, nq, self.dim)
        attn_windows = attn_windows.view(-1, self.window_size, self.window_size, self.dim)
        x = window_reverse(attn_windows, self.window_size, h, w)
        x = x.view(b, h * w, self.dim)
        x = self.proj(x) + shortcut
        return x + self.mlp(self.norm2(x))


class AttenBlocks(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, compress_ratio, squeeze_factor,
                 conv_scale, overlap_ratio, mlp_ratio):
        super().__init__()
        self.blocks = nn.ModuleList([
            HAB(dim, num_heads, window_size, 0 if (i % 2 == 0) else window_size // 2,
                compress_ratio, squeeze_factor, conv_scale, mlp_ratio)
            for i in range(depth)])
        self.overlap_attn = OCAB(dim, window_size, overlap_ratio, num_heads, mlp_ratio)

    def forward(self, x, x_size, params):
        for blk in self.blocks:
            x = blk(x, x_size, params["rpi_sa"], params["attn_mask"])
        return self.overlap_attn(x, x_size, params["rpi_oca"])


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim, norm):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dim) if norm else None

    def forward(self, x):
        x = x.flatten(2).transpose(1, 2)
        return self.norm(x) if self.norm is not None else x


def patch_unembed(x, x_size):
    b, _, c = x.shape
    return x.transpose(1, 2).view(b, c, x_size[0], x_size[1])


class RHAG(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, compress_ratio, squeeze_factor,
                 conv_scale, overlap_ratio, mlp_ratio, resi_connection="1conv"):
        super().__init__()
        self.residual_group = AttenBlocks(dim, depth, num_heads, window_size, compress_ratio,
                                          squeeze_factor, conv_scale, overlap_ratio, mlp_ratio)
        if resi_connection == "1conv":
            self.conv = nn.Conv2d(dim, dim, 3, 1, 1)
        elif resi_connection == "identity":
            self.conv = nn.Identity()
        self.patch_embed = PatchEmbed(dim, norm=False)

    def forward(self, x, x_size, params):
        y = patch_unembed(self.residual_group(x, x_size, params), x_size)
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


class HAT(nn.Module):
    """``HAT(upscale=4, in_chans=3, img_size=64, window_size=16,
    compress_ratio=3, squeeze_factor=30, conv_scale=0.01, overlap_ratio=0.5,
    img_range=1., depths=[6]*6, embed_dim=180, num_heads=[6]*6, mlp_ratio=2,
    upsampler='pixelshuffle', resi_connection='1conv')`` is Real-HAT-GAN
    (``options/test/HAT_GAN_Real_SRx4.yml``)."""

    def __init__(self, img_size=64, in_chans=3, embed_dim=96, depths=(6, 6, 6, 6),
                 num_heads=(6, 6, 6, 6), window_size=7, compress_ratio=3, squeeze_factor=30,
                 conv_scale=0.01, overlap_ratio=0.5, mlp_ratio=4., upscale=2, img_range=1.,
                 upsampler="", resi_connection="1conv"):
        super().__init__()
        num_out_ch, num_feat = in_chans, 64
        self.img_range = img_range
        self.mean = (torch.Tensor((0.4488, 0.4371, 0.4040)).view(1, 3, 1, 1) if in_chans == 3
                     else torch.zeros(1, 1, 1, 1))
        self.upscale, self.upsampler = upscale, upsampler
        self.window_size, self.overlap_ratio = window_size, overlap_ratio
        self.register_buffer("relative_position_index_SA", self.calculate_rpi_sa())
        self.register_buffer("relative_position_index_OCA", self.calculate_rpi_oca())
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbed(embed_dim, norm=True)
        self.layers = nn.ModuleList([
            RHAG(embed_dim, depths[i], num_heads[i], window_size, compress_ratio,
                 squeeze_factor, conv_scale, overlap_ratio, mlp_ratio, resi_connection)
            for i in range(len(depths))])
        self.norm = nn.LayerNorm(embed_dim)
        if resi_connection == "1conv":
            self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)
        elif resi_connection == "identity":
            self.conv_after_body = nn.Identity()
        if upsampler == "pixelshuffle":
            self.conv_before_upsample = nn.Sequential(nn.Conv2d(embed_dim, num_feat, 3, 1, 1),
                                                      nn.LeakyReLU(inplace=True))
            self.upsample = Upsample(upscale, num_feat)
            self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def calculate_rpi_sa(self):
        coords_h = torch.arange(self.window_size)
        coords_w = torch.arange(self.window_size)
        coords = torch.stack(torch.meshgrid([coords_h, coords_w], indexing="ij"))
        coords_flatten = torch.flatten(coords, 1)
        relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
        relative_coords = relative_coords.permute(1, 2, 0).contiguous()
        relative_coords[:, :, 0] += self.window_size - 1
        relative_coords[:, :, 1] += self.window_size - 1
        relative_coords[:, :, 0] *= 2 * self.window_size - 1
        return relative_coords.sum(-1)

    def calculate_rpi_oca(self):
        window_size_ori = self.window_size
        window_size_ext = self.window_size + int(self.overlap_ratio * self.window_size)
        coords_h = torch.arange(window_size_ori)
        coords_w = torch.arange(window_size_ori)
        coords_ori = torch.stack(torch.meshgrid([coords_h, coords_w], indexing="ij"))
        coords_ori_flatten = torch.flatten(coords_ori, 1)
        coords_h = torch.arange(window_size_ext)
        coords_w = torch.arange(window_size_ext)
        coords_ext = torch.stack(torch.meshgrid([coords_h, coords_w], indexing="ij"))
        coords_ext_flatten = torch.flatten(coords_ext, 1)
        relative_coords = coords_ext_flatten[:, None, :] - coords_ori_flatten[:, :, None]
        relative_coords = relative_coords.permute(1, 2, 0).contiguous()
        relative_coords[:, :, 0] += window_size_ori - window_size_ext + 1
        relative_coords[:, :, 1] += window_size_ori - window_size_ext + 1
        relative_coords[:, :, 0] *= window_size_ori + window_size_ext - 1
        return relative_coords.sum(-1)

    def calculate_mask(self, x_size):
        h, w = x_size
        img_mask = torch.zeros((1, h, w, 1))
        ws, s = self.window_size, self.window_size // 2
        slices = (slice(0, -ws), slice(-ws, -s), slice(-s, None))
        cnt = 0
        for hs in slices:
            for wsl in slices:
                img_mask[:, hs, wsl, :] = cnt
                cnt += 1
        mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
        attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
        return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(
            attn_mask == 0, float(0.0))

    def forward_features(self, x):
        x_size = (x.shape[2], x.shape[3])
        attn_mask = self.calculate_mask(x_size).to(x.device)
        params = {"attn_mask": attn_mask, "rpi_sa": self.relative_position_index_SA,
                  "rpi_oca": self.relative_position_index_OCA}
        x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x, x_size, params)
        return patch_unembed(self.norm(x), x_size)

    def forward(self, x):
        # hat_model.py::pre_process: reflect to the window's multiple; the crop after
        _, _, h, w = x.shape
        ws = self.window_size
        x = TF.pad(x, (0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws), "reflect")
        mean = self.mean.type_as(x)
        x = (x - mean) * self.img_range
        x = self.conv_first(x)
        x = self.conv_after_body(self.forward_features(x)) + x
        x = self.conv_last(self.upsample(self.conv_before_upsample(x)))
        x = x / self.img_range + mean
        return x[:, :, :h * self.upscale, :w * self.upscale]


def seeded(model: HAT, seed: int, *, bias_std: float = 1.0, cab_gain: float = 30.0,
           gate_std: float = 1.5) -> HAT:
    """``model`` with seeded weights that make each part of the block show:
    linears and convs at unit gain, the CAB's second conv at ``cab_gain``
    (so that ``conv_scale`` x its output is not lost beside the attention),
    the channel attention's last bias with std ``gate_std`` (gates spread
    over (0, 1)), LayerNorm affines spread about (1, 0), the relative-position
    tables with std ``bias_std`` (the published init, 0.02, would hide them
    in any tolerance), and every other bias spread by 0.02."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if name.endswith("relative_position_bias_table"):
                p.copy_(r * bias_std)
            elif p.dim() > 1:
                gain = cab_gain if name.endswith("conv_block.cab.2.weight") else 1.0
                p.copy_(r * gain / math.sqrt(p[0].numel()))
            elif ".norm" in name or name.startswith("norm."):
                p.copy_(1.0 + 0.1 * r if name.endswith("weight") else 0.1 * r)
            elif name.endswith("attention.3.bias"):
                p.copy_(gate_std * r)
            else:
                p.copy_(0.02 * r)
    return model.eval()
