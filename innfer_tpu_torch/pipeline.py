"""Inference pipeline: presets, model-chain resolution, device pre/post,
and the per-directory image loop.

The port's counterpart of ``innfer_tpu/pipeline.py`` (reference
run.py:229-447), for state-dict checkpoints and TorchScript archives
(``-a ts`` or its fingerprint; fp32, compat/torchscript.py):
  * arch-family presets (pix2pix: linear_resize, train-mode norm, [-1, 1];
    cyclegan; wbc: modcrop, the guided filter after each stage) and
    model-chain parsing ('+' or '>'; exact path -> ./models ->
    case-insensitive substring search, scale from the 'Nx_' filename
    prefix of each stage);
  * the stages run one after another on the whole image (the reference's
    sequential chain), each tiled or whole-image, the latter under a
    memory guard;
  * the u8 image uploads as u8 and is scaled on the device; the output is
    rounded to u8 on the device (and color-fixed there with ``-cf``) and
    copied to pinned host memory asynchronously;
  * ``process`` overlaps decoding (a prefetch pool) and PNG encoding (a
    background pool) with the device's work, and drains both on any exit.

bfloat16 replaces the reference's fp16; every conv accumulates in fp32.
Batched directory mode, the fused tile-through-chain and metrics come with
a later slice (ROADMAP.md queue A15).
"""
from __future__ import annotations

import logging
import os.path as osp
import re
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from innfer_tpu_torch.compat.torchscript import (FitTileRunner, is_torchscript,
                                                 load_torchscript)
from innfer_tpu_torch.device import DeviceLike, resolve_device
from innfer_tpu_torch.io import images as iio
from innfer_tpu_torch.loader import load_model
from innfer_tpu_torch.models import get_network
from innfer_tpu_torch.models.base import ModelDef, Params
from innfer_tpu_torch.ops import colors
from innfer_tpu_torch.ops.filters import color_fix, guided_filter
from innfer_tpu_torch.tiling.engine import TiledRunner

log = logging.getLogger("innfer_tpu_torch")

# host threads beside the device: decodes run ahead, encodes trail behind
_DECODE_THREADS = 2
_ENCODE_THREADS = 2

# ---------------------------------------------------------------------------
# Presets (reference run.py:299-315, 347-379)
# ---------------------------------------------------------------------------


@dataclass
class Presets:
    meval: bool = True
    strict: bool = True
    normalize: bool = False
    chop: bool = True
    resize: int = 0           # linear_resize target (unet/p2p families)
    use_guided_filter: bool = False
    use_modcrop: bool = False
    arch: str = "infer"
    family: str = "default"   # pix2pix | cyclegan | wbc | default


def _has_tf_token(s: str) -> bool:
    """'tf' as a delimited token ('wbc_tf', '4x.tf.pth'), not inside a word."""
    return bool(re.search(r"(?:^|[^0-9a-zA-Z])tf(?:[^0-9a-zA-Z]|$)", s))


def select_presets(arch: str, models_arg: str = "", norm_flag: bool = False) -> Presets:
    """Arch-family preset selection (run.py:347-379)."""
    p = Presets(arch=arch)
    if ("unet_" in arch or "p2p_" in arch) and "wbc" not in arch:
        p.meval, p.strict, p.normalize = False, True, True
        p.chop = False
        p.family = "pix2pix"
        p.resize = next((s for s in (512, 256, 128) if str(s) in arch), 256)
    elif "resnet_" in arch or "cg_" in arch:
        p.meval, p.strict, p.normalize = True, False, True
        p.family = "cyclegan"
    elif "wbc" in arch or "wbc" in models_arg:
        tf = _has_tf_token(arch) or _has_tf_token(models_arg)
        p.arch = "wbcunet_tf" if tf else "wbcunet"
        p.meval, p.strict, p.normalize = False, True, True
        p.chop = False
        p.use_guided_filter = True
        p.use_modcrop = True
        p.family = "wbc"
    if norm_flag:
        p.normalize = True
    return p


# ---------------------------------------------------------------------------
# Model resolution (run.py:229-293)
# ---------------------------------------------------------------------------


def check_model_path(model_path: str, all_models: Optional[Sequence[str]] = None,
                     models_dir: str = "./models") -> str:
    if osp.isfile(model_path):
        return model_path
    alt = osp.join(models_dir, model_path)
    if osp.isfile(alt):
        return alt
    if all_models:
        matches = [m for m in all_models if model_path.lower() in str(m).lower()]
        if len(matches) > 1:
            raise ValueError(f"Filter {model_path} returned multiple models: {matches}.")
        if matches:
            return matches[0]
    raise ValueError(f"Model {model_path} not found.")


def get_scale_name(model_path: str, scale: Optional[int] = None) -> Optional[int]:
    """Scale from the 'Nx'/'xN' two-char filename prefix (run.py:278-293)."""
    prefix = str(osp.basename(model_path)[0:2]).lower()
    rlt = None
    if "x" in prefix:
        try:
            rlt = int(prefix.replace("x", ""))
        except ValueError:
            rlt = None
    if scale:
        if rlt and scale != rlt:
            print(f"Warning: possible model scale mismatch on {model_path}")
        return scale
    return rlt


def parse_models(models_arg: str, scales: Optional[List[Optional[int]]] = None,
                 models_dir: str = "./models") -> Tuple[List[str], List[Optional[int]]]:
    chain = models_arg.split("+") if "+" in models_arg else models_arg.split(">")
    try:
        all_models = iio.get_models_paths(models_dir)
    except AssertionError:
        all_models = None
    paths = [check_model_path(m, all_models, models_dir) for m in chain]
    if scales is None:
        scales = [get_scale_name(p) for p in paths]
    elif len(scales) != len(paths):
        raise ValueError(
            f"The num. of scales {len(scales)} is != from number of models {len(paths)}")
    return paths, scales


# ---------------------------------------------------------------------------
# Device pre/post conversion (utils.py:164-248)
# ---------------------------------------------------------------------------


def np2tensor(img: np.ndarray, *, normalize: bool = False,
              dtype: torch.dtype = torch.float32,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """HWC BGR uint8/uint16 numpy -> (1, H, W, C) RGB float tensor on
    ``device``.  The image uploads in its source dtype and is scaled there."""
    if not isinstance(img, np.ndarray):
        raise TypeError("Got unexpected object type, expected np.ndarray")
    if img.ndim == 2:
        img = img[:, :, None]
    maxval = iio.MAX_VALUES_BY_DTYPE.get(img.dtype, 1.0)
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    x = x.to(torch.float32) / maxval
    c = x.shape[-1]
    if c % 3 == 0:
        x = colors.bgr_to_rgb(x)
    elif c == 4:
        x = colors.bgra_to_rgba(x)
    if normalize:
        x = colors.norm(x)
    return x[None].to(dtype)


def _postprocess_u8(x: torch.Tensor, *, denormalize: bool = False) -> torch.Tensor:
    """(1, H, W, C) RGB float -> HWC BGR uint8, on the tensor's device."""
    x = x[0].float()
    c = x.shape[-1]
    if c == 3:
        x = colors.rgb_to_bgr(x)
    elif c == 4:
        x = colors.rgba_to_bgra(x)
    if denormalize:
        x = colors.denorm(x)
    return torch.round(torch.clamp(255.0 * x, 0, 255)).to(torch.uint8)


class HostCopy:
    """A u8 device output on its way to host memory: the copy into pinned
    memory is queued at dispatch time, on the stream that produced it, and
    ``fetch()`` (run on the encode pool) waits only for that copy."""

    def __init__(self, u8: torch.Tensor):
        if u8.is_cuda:
            self.host = torch.empty(u8.shape, dtype=u8.dtype, pin_memory=True)
            self.host.copy_(u8, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host, self.done = u8, None

    def fetch(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()


# ---------------------------------------------------------------------------
# Per-stage execution
# ---------------------------------------------------------------------------


def whole_image_budget(device: torch.device) -> Optional[int]:
    """Bytes a whole-image forward may take on ``device``: half the card's
    memory, as the JAX package budgets half of the v5e's 16 GB
    (innfer_tpu/pipeline.py:315-317); None (no limit) on the CPU, where
    the JAX package waives it too."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory // 2


def _whole_forward_bytes(model: ModelDef, x_shape: Sequence[int]) -> int:
    """Peak-activation estimate of an untiled forward of an (N, H, W, C)
    input, the JAX package's per-architecture formula
    (innfer_tpu/pipeline.py:320-347).

    SR families are dominated by the upsample tail (a few nf-wide fp32
    maps at output resolution) plus the dense-concat width at LR.
    Image-to-image families (scale 1) peak at input resolution: UNet's
    outermost skip concat (2 ngf, ~3 maps live), CycleGAN's ngf maps plus
    reflect-pad copies, WBC's nf maps."""
    px = x_shape[0] * x_shape[1] * x_shape[2]
    cfg = model.cfg
    kind = str(cfg.get("type", ""))
    nf = int(cfg.get("nf", cfg.get("ngf", 64)))
    if kind == "unet_net":
        return px * int(cfg.get("ngf", 64)) * 2 * 4 * 3
    if kind == "resnet_net":
        return px * int(cfg.get("ngf", 64)) * 4 * 4
    if kind == "wbcunet_net":
        return px * nf * 4 * 4
    gc = int(cfg.get("gc", 0) or 0)
    lr_width = nf + 4 * gc if gc else nf
    return px * lr_width * 4 * 2 + px * model.scale ** 2 * nf * 4 * 3


@dataclass
class Stage:
    """One model of the chain plus its tiled runner (None: whole-image
    forwards)."""

    model: ModelDef
    params: Params
    chop: bool
    runner: Optional[TiledRunner] = None
    _fallback: Optional[TiledRunner] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.chop and self.runner is not None:
            return self.runner(self.params, x)
        budget = whole_image_budget(x.device)
        need = _whole_forward_bytes(self.model, x.shape)
        if budget is not None and need > budget:
            # the whole image would overflow the card: tile instead, unless
            # the stage's numerics depend on the whole image (train-mode
            # normalization computes its statistics over it)
            cfg = self.model.cfg
            if not cfg.get("meval", True) and cfg.get("norm_type") not in (None, "none"):
                raise ValueError(
                    f"whole-image forward of {x.shape[1]}x{x.shape[2]} would "
                    f"need ~{need / 1024 ** 3:.1f} GB of device memory, and this "
                    "stage runs train-mode normalization whose statistics are "
                    "whole-image-dependent — tiled execution would change the "
                    "output.  Resize the input (the reference resizes pix2pix "
                    "inputs to 256/512) or run on a device with more memory.")
            if self._fallback is None:
                log.warning("whole-image forward of %dx%d would need ~%.1f GB of "
                            "device memory; falling back to tiled execution",
                            x.shape[1], x.shape[2], need / 1024 ** 3)
                self._fallback = TiledRunner(
                    self.model.apply, self.model.scale, mode="auto",
                    output_index=self.model.output_index, compute_dtype=x.dtype)
            return self._fallback(self.params, x)
        out = self.model.apply(self.params, x)
        return out if self.model.output_index is None else out[self.model.output_index]


class InferenceSession:
    """A loaded model chain ready to process images on ``device`` (the CUDA
    device unless ``device="cpu"``): the stages run one after another,
    with the guided filter after each where the preset asks for it."""

    def __init__(
        self,
        models_arg: str,
        *,
        arch: str = "infer",
        models_dir: str = "./models",
        presets: Optional[Presets] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        tile=256,
        overlap: int = 16,
        tile_mode: str = "uniform",
        tile_batch: int = 8,
        scale: Optional[int] = None,
        device: DeviceLike = None,
        backend: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.presets = presets or select_presets(arch, models_arg)
        # -s applies to a single model only, like the reference (run.py:
        # 391-394): a chain takes its per-stage scales from the filenames
        paths, scales = parse_models(models_arg, None, models_dir)
        if scale is not None:
            if len(paths) == 1:
                scales = [scale]
            elif any(s != scale for s in scales):
                log.warning("-s %d ignored for the %d-model chain (per-stage scales "
                            "%s come from the filenames, like the reference)",
                            scale, len(paths), scales)
        is_ts = [self.presets.arch == "ts" or is_torchscript(p) for p in paths]
        # the reference turns fp16 off for TorchScript (run.py:341-343)
        self.compute_dtype = torch.float32 if any(is_ts) else compute_dtype
        self.stages: List[Stage] = []
        for path, sc, ts in zip(paths, scales, is_ts):
            runner = None
            if ts:
                model, params = load_torchscript(path, device=self.device, scale=sc)
                if self.presets.chop:
                    runner = FitTileRunner(model.apply, model.scale, tile=tile,
                                           overlap=overlap, tile_batch=tile_batch)
            else:
                model, params = load_model(
                    path, arch=self.presets.arch, scale=sc,
                    param_dtype=self.compute_dtype, device=self.device,
                    backend=backend, strict=self.presets.strict)
                if not self.presets.meval:
                    # rebuild with train-mode norm (the pix2pix preset's BN)
                    rebuilt = get_network({**model.cfg, "meval": False})
                    rebuilt.remap = model.remap
                    model = rebuilt
                if self.presets.chop:
                    runner = TiledRunner(
                        model.apply, model.scale, mode=tile_mode, tile=tile,
                        overlap=overlap, tile_batch=tile_batch,
                        compute_dtype=self.compute_dtype, trunk_fn=model.apply_trunk,
                        tail_fn=model.apply_tail, tail_halo=model.tail_halo,
                        trunk_kernel=model.trunk_kernel, output_index=model.output_index)
            self.stages.append(Stage(model, params, self.presets.chop, runner))
        log.info("innfer_tpu_torch session on %s, %s compute, %d stage(s), image "
                 "codec: %s", self.device, self.compute_dtype, len(self.stages),
                 iio.codec_name())

    def prepare(self, img: np.ndarray) -> np.ndarray:
        if self.presets.resize:
            img = iio.linear_resize(img, self.presets.resize, device=self.device)
        if self.presets.use_modcrop:
            img = iio.modcrop(img, 4)
        return img

    def forward(self, t_img: torch.Tensor) -> torch.Tensor:
        """The chain on an (N, H, W, C) device tensor: each stage on the
        whole image in turn, and after each, where the preset asks for it
        (WBC), the guided filter against the input (run.py:425-429)."""
        t_out = t_img
        for stage in self.stages:
            t_out = stage(t_out)
            if self.presets.use_guided_filter:
                t_out = guided_filter(t_img, t_out, r=1, eps=5e-3)
        return t_out

    def run_image(self, img: np.ndarray, *, already_prepared: bool = False,
                  host_copy: bool = False, color_ref: Optional[np.ndarray] = None):
        """prepare -> chain -> u8 BGR.  Returns numpy, or with
        ``host_copy=True`` a :class:`HostCopy` whose transfer is queued.

        ``color_ref`` (the prepared u8 input, on the host) applies
        color_fix on the device before the copy: uploading the small input
        moves fewer bytes than fetching the output and uploading it back."""
        if not already_prepared:
            img = self.prepare(img)
        t_img = np2tensor(img, normalize=self.presets.normalize,
                          dtype=self.compute_dtype, device=self.device)
        u8 = _postprocess_u8(self.forward(t_img), denormalize=self.presets.normalize)
        if color_ref is not None:
            ref = torch.from_numpy(np.ascontiguousarray(color_ref)).to(self.device)
            u8 = color_fix(ref.reshape(ref.shape[:2] + (-1,)), u8)
        out = HostCopy(u8)
        return out if host_copy else out.fetch()

    def process(self, input_dir: str, output_dir: str, *, use_color_fix: bool = False,
                comp: bool = False, verbose: bool = True) -> List[str]:
        """Process a directory of images; returns the written paths.

        Upcoming images decode on a prefetch pool while the device works;
        finished outputs are fetched and PNG-encoded on a background pool.
        ``use_color_fix`` (-cf) transfers the prepared input's color to
        the output on the device; ``comp`` (-comp) writes the prepared
        input and the output side by side.  Write errors surface at the
        end-of-run drain; on any error the queued work is cancelled and
        both pools are shut down."""
        paths = iio.get_images_paths(input_dir)
        written: List[str] = []
        dec_pool = ThreadPoolExecutor(max_workers=_DECODE_THREADS,
                                      thread_name_prefix="innfer-decode")
        enc_pool = ThreadPoolExecutor(max_workers=_ENCODE_THREADS,
                                      thread_name_prefix="innfer-encode")
        ahead = 2 * _DECODE_THREADS
        decodes: List[Future] = []
        encodes: List[Future] = []

        def finalize(out: HostCopy, dst: str, src: str, img_in: np.ndarray):
            img = out.fetch()
            if comp:
                iio.save_img_comp([img_in, img], dst)
            else:
                iio.save_img(img, dst)
            if verbose:
                print(f"{src} -> {dst} {img.shape[1]}x{img.shape[0]}")

        try:
            decodes = [dec_pool.submit(iio.read_img, p) for p in paths[:ahead]]
            for i, src in enumerate(paths):
                img = decodes[i].result()
                if i + ahead < len(paths):
                    decodes.append(dec_pool.submit(iio.read_img, paths[i + ahead]))
                if img is None:
                    print(f"Error reading image {src}, skipping.")
                    continue
                img = self.prepare(img)
                out = self.run_image(img, already_prepared=True, host_copy=True,
                                     color_ref=img if use_color_fix else None)
                dst = osp.join(output_dir, osp.splitext(osp.basename(src))[0] + ".png")
                # bound the outputs in flight: each pins a full SR image
                while len(encodes) >= 2 * _ENCODE_THREADS + 2:
                    encodes.pop(0).result()
                encodes.append(enc_pool.submit(finalize, out, dst, src, img))
                written.append(dst)
            for f in encodes:
                f.result()  # surface write errors
        except BaseException:
            for f in decodes + encodes:
                f.cancel()
            raise
        finally:
            dec_pool.shutdown(wait=True)
            enc_pool.shutdown(wait=True)
        return written
