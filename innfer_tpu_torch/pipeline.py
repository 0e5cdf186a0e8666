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
    background pool, ``INNFER_ENCODE_THREADS``) with the device's work,
    and drains both on any exit;
  * batched directory mode (``process(batch=)``, ``run_batch``): same-shape
    images are stacked into one whole-image forward where it fits the
    memory budget, else into shared tile groups (chopped presets), else
    run one by one; ``batch=0`` sizes each shape's group (``auto_batch``);
  * the opt-in fused tile-through-chain (``fused_chain=True``), per-stage
    timers, and PSNR/SSIM against a ground-truth directory;
  * a device mesh (``mesh=``, ``parallel/mesh.py``): tile groups and
    whole-image stacks split over its data devices, conv weights sharded
    over its model devices, or with ``spatial=True`` each image's forward
    H-sharded over the data devices with halo exchange
    (``parallel/spatial_model.SpatialRunner``).

bfloat16 replaces the reference's fp16; every conv accumulates in fp32.

Not carried from the JAX package: its CycleGAN batch-4 fence (an XLA
compile stall) and the padding of partial groups to a compiled shape
(eager PyTorch has no compiled shape to reuse, so a padded image would be
wasted device work: partial groups run at their natural size).
"""
from __future__ import annotations

import logging
import os
import os.path as osp
import re
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from innfer_tpu_torch.compat.torchscript import (FitTileRunner, is_torchscript,
                                                 load_torchscript)
from innfer_tpu_torch.device import DeviceLike, resolve_device, set_cudnn_deterministic
from innfer_tpu_torch.io import images as iio
from innfer_tpu_torch.loader import load_model
from innfer_tpu_torch.metrics import psnr_np, ssim_np
from innfer_tpu_torch.models import get_network
from innfer_tpu_torch.models.base import ModelDef, Params
from innfer_tpu_torch.observability import TRACER, span, stage
from innfer_tpu_torch.ops import colors
from innfer_tpu_torch.ops.filters import color_fix, guided_filter
from innfer_tpu_torch.parallel.mesh import (Mesh, data_parallel, params_on,
                                            replicate_params, tp_shard_params)
from innfer_tpu_torch.parallel.multihost import shard_paths
from innfer_tpu_torch.parallel.spatial_model import (SpatialRunner, spatial_rejection_reason,
                                                     spatial_supported)
from innfer_tpu_torch.runtime.native import PrefetchLoader
from innfer_tpu_torch.tiling.engine import TiledRunner

log = logging.getLogger("innfer_tpu_torch")

def _find_reference(metrics_dir: str, name: str) -> Optional[np.ndarray]:
    """The ground-truth image named ``name`` in ``metrics_dir``."""
    for ext in (".png", ".jpg", ".jpeg", ".bmp", ".webp"):
        p = osp.join(metrics_dir, name + ext)
        if osp.isfile(p):
            return iio.read_img(p)
    return None


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
    ``device``; a stacked (N, H, W, C) batch of same-shape images converts
    as one tensor.  The image uploads in its source dtype and is scaled
    there."""
    if not isinstance(img, np.ndarray):
        raise TypeError("Got unexpected object type, expected np.ndarray")
    batched = img.ndim == 4
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
    return (x if batched else x[None]).to(dtype)


def _postprocess_u8(x: torch.Tensor, *, denormalize: bool = False,
                    batched: bool = False) -> torch.Tensor:
    """(1, H, W, C) RGB float -> HWC BGR uint8, on the tensor's device;
    ``batched`` keeps the leading axis: (N, H, W, C) -> (N, H, W, C)."""
    x = x.float() if batched else x[0].float()
    c = x.shape[-1]
    if c == 3:
        x = colors.rgb_to_bgr(x)
    elif c == 4:
        x = colors.rgba_to_bgra(x)
    if denormalize:
        x = colors.denorm(x)
    return torch.round(torch.clamp(255.0 * x, 0, 255)).to(torch.uint8)


def _to_u8(x: torch.Tensor, ref: Optional[np.ndarray], *, denormalize: bool,
           batched: bool = False) -> torch.Tensor:
    """:func:`_postprocess_u8`, then color_fix against the host u8 ``ref``
    (uploaded here) where there is one: the span ``innfer.postprocess``."""
    with span("innfer.postprocess", x.device):
        u8 = _postprocess_u8(x, denormalize=denormalize, batched=batched)
        if ref is None:
            return u8
        return color_fix(torch.from_numpy(np.ascontiguousarray(ref)).to(x.device), u8)


class HostCopy:
    """A u8 device output on its way to host memory: the copy into pinned
    memory is queued at dispatch time (:meth:`start`), on the stream that
    produced it, and ``fetch()`` (run on the encode pool) waits only for
    that copy.  A stacked group's copy is one pinned buffer, one transfer
    and one event, handed out per image by :meth:`split`."""

    def __init__(self, host: torch.Tensor, done: Optional["torch.cuda.Event"] = None):
        self.host, self.done = host, done

    @classmethod
    def start(cls, u8: torch.Tensor) -> "HostCopy":
        if not u8.is_cuda:
            return cls(u8)
        with span("innfer.download", u8.device):
            host = torch.empty(u8.shape, dtype=u8.dtype, pin_memory=True)
            host.copy_(u8, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return cls(host, done)

    def split(self) -> List["HostCopy"]:
        """One HostCopy per image of a stacked (N, H, W, C) copy."""
        return [HostCopy(h, self.done) for h in self.host.unbind(0)]

    def fetch(self, timers=None, **kw) -> np.ndarray:
        """The host's wait for the copy: the stage ``fetch`` of ``timers``
        (``observability.StageTimers``), or its span alone; ``kw``: the
        span's (a request id)."""
        with stage(timers, "fetch", **kw):
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
        # leaves out fused_resnet_block's fp32 scratch (4 ngf channels at a
        # quarter of the pixels, about 6% of this), as the JAX formula has
        # no such buffer to count
        return px * int(cfg.get("ngf", 64)) * 4 * 4
    if kind == "wbcunet_net":
        return px * nf * 4 * 4
    gc = int(cfg.get("gc", 0) or 0)
    lr_width = nf + 4 * gc if gc else nf
    return px * lr_width * 4 * 2 + px * model.scale ** 2 * nf * 4 * 3


@dataclass
class Stage:
    """One model of the chain plus its tiled or spatial runner (None:
    whole-image forwards).  On a ``mesh`` its params are
    ``parallel/mesh.MeshParams`` and each forward takes its device's."""

    model: ModelDef
    params: Params
    chop: bool
    runner: Optional[TiledRunner] = None
    mesh: Optional[Mesh] = None
    _fallback: Optional[TiledRunner] = None

    def __call__(self, x: torch.Tensor, *, force_whole: bool = False) -> torch.Tensor:
        """``force_whole`` bypasses the tiled runner and the memory guard:
        a batched group runs its stack whole-image, and ``run_batch`` has
        checked the budget for it (``InferenceSession.batchable``)."""
        if self.chop and self.runner is not None and not force_whole:
            return self.runner(self.params, x)
        budget = whole_image_budget(x.device)
        need = _whole_forward_bytes(self.model, x.shape)
        if not force_whole and budget is not None and need > budget:
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
                    output_index=self.model.output_index, compute_dtype=x.dtype,
                    mesh=self.mesh)
            return self._fallback(self.params, x)
        out = self.model.apply(params_on(self.params, x.device), x)
        return out if self.model.output_index is None else out[self.model.output_index]


class InferenceSession:
    """A loaded model chain ready to process images on ``device`` (the CUDA
    device unless ``device="cpu"``): the stages run one after another,
    with the guided filter after each where the preset asks for it.

    ``fused_chain=True`` (opt-in, as in the JAX package) runs a chain of
    two or more models as one tile pass instead (:meth:`build_fused_chain`).

    ``mesh`` (``parallel/mesh.make_mesh``) follows the JAX package's rules
    (innfer_tpu/pipeline.py:455-541): the tile batch is rounded up to a
    multiple of the data-axis size; params are tp-sharded where the model
    axis is above 1, else replicated; ``spatial=True`` runs each supported
    stage through a :class:`SpatialRunner` and refuses the rest, TorchScript
    and a model axis above 1 with the reason.

    Building a session sets cuDNN's ``deterministic`` flag for the process,
    as the reference does (``device.set_cudnn_deterministic``)."""

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
        fused_chain: bool = False,
        mesh: Optional[Mesh] = None,
        spatial: bool = False,
    ):
        self.device = resolve_device(device)
        set_cudnn_deterministic()
        if spatial and mesh is None:
            raise ValueError("spatial=True needs a device mesh (make_mesh, CLI --dp N)")
        if spatial and mesh.shape.get("model", 1) > 1:
            raise NotImplementedError(
                "--spatial shards the image over the 'data' axis only; "
                "combining it with --tp would run every halo conv on "
                "gathered weights.  Use --spatial with --dp alone.")
        self._mesh = mesh
        self._spatial = spatial
        if mesh is not None:
            # dp requires whole slices per device: round the tile batch up
            n_data = mesh.shape.get("data", 1)
            tile_batch = -(-tile_batch // n_data) * n_data
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
                if spatial:
                    raise NotImplementedError(
                        "--spatial cannot shard a TorchScript module (its "
                        "forward is opaque to the halo exchange); remove --spatial")
                model, params = load_torchscript(path, device=self.device, scale=sc)
                if self.presets.chop:
                    runner = FitTileRunner(model.apply, model.scale, tile=tile,
                                           overlap=overlap, tile_batch=tile_batch)
            else:
                model, params = load_model(
                    path, arch=self.presets.arch, scale=sc,
                    param_dtype=self.compute_dtype, device=self.device,
                    strict=self.presets.strict)
                if model.cfg.get("convtype") == "Conv3D":
                    raise ValueError(
                        "evsrgan (Conv3D) is a video network with 5D NDHWC "
                        "inputs; the image pipeline cannot feed it (the "
                        "reference CLI cannot either) — use the library API "
                        "(innfer_tpu_torch.loader + model.apply) instead")
                if not self.presets.meval:
                    # rebuild with train-mode norm (the pix2pix preset's BN)
                    rebuilt = get_network({**model.cfg, "meval": False})
                    rebuilt.remap = model.remap
                    model = rebuilt
                if mesh is not None and mesh.shape.get("model", 1) > 1:
                    params = tp_shard_params(params, mesh, transposed=model.transposed_keys)
                elif mesh is not None:
                    params = replicate_params(params, mesh)
                if spatial:
                    # the whole image's forward, H-sharded over the mesh
                    # with per-conv halo exchange
                    if not spatial_supported(model.cfg):
                        raise NotImplementedError(
                            "--spatial: " + spatial_rejection_reason(model.cfg))
                    runner = SpatialRunner(model, mesh)
                elif self.presets.chop:
                    runner = TiledRunner(
                        model.apply, model.scale, mode=tile_mode, tile=tile,
                        overlap=overlap, tile_batch=tile_batch,
                        compute_dtype=self.compute_dtype, trunk_fn=model.apply_trunk,
                        tail_fn=model.apply_tail, tail_halo=model.tail_halo,
                        trunk_kernel=model.trunk_kernel, output_index=model.output_index,
                        mesh=mesh, hybrid_canvas=model.hybrid_canvas)
            self.stages.append(Stage(model, params, self.presets.chop or spatial, runner,
                                     mesh=mesh))
        self._fused_runner: Optional[TiledRunner] = None
        if fused_chain and len(self.stages) > 1:
            if self.presets.use_guided_filter:
                raise ValueError(
                    "fused_chain cannot apply the per-stage guided filter "
                    "(wbc preset); use fused_chain=False")
            if self.has_torchscript:
                raise ValueError(
                    "fused_chain cannot run TorchScript stages inside the tile "
                    "pass; use fused_chain=False (chains with a ts stage run "
                    "the sequential path)")
            # cap the input tile so that the final-scale tile stays bounded,
            # and grow the overlap with the chain's depth (its combined
            # receptive field), as the JAX package does
            fused_tile = min(tile, max(64, 1024 // max(self.total_scale, 1)))
            fused_overlap = min(overlap * len(self.stages), fused_tile // 3)
            self._fused_runner = self.build_fused_chain(
                tile=fused_tile, overlap=fused_overlap, tile_batch=tile_batch,
                mode="auto" if tile_mode == "hybrid" else tile_mode, mesh=mesh)
        self.last_metrics: List[dict] = []
        log.info("innfer_tpu_torch session on %s, %s compute, %d stage(s), image "
                 "codec: %s", self.device, self.compute_dtype, len(self.stages),
                 iio.codec_name())

    @property
    def total_scale(self) -> int:
        s = 1
        for st in self.stages:
            s *= st.model.scale
        return s

    @property
    def has_torchscript(self) -> bool:
        return any(st.model.cfg.get("type") == "torchscript" for st in self.stages)

    def build_fused_chain(self, *, tile: int = 128, overlap: int = 8,
                          tile_batch: int = 8, mode: str = "uniform",
                          mesh: Optional[Mesh] = None) -> TiledRunner:
        """Tile-through-chain execution: one tile pass runs every stage on
        each tile and blends once at the final scale, so no intermediate
        image is materialized.  Opt-in, as in the JAX package (slower
        there than the sequential stages on its product chain); outputs
        may differ from the sequential path near tile borders, within the
        chain's combined receptive field.  The stages' ops round and run
        true fp32 as the sequential path's do (``nn/functional``)."""
        stages = self.stages

        def chained(_params, t):
            for st in stages:
                out = st.model.apply(params_on(st.params, t.device), t)
                t = out if st.model.output_index is None else out[st.model.output_index]
            return t

        return TiledRunner(chained, self.total_scale, mode=mode, tile=tile,
                           overlap=overlap, tile_batch=tile_batch,
                           compute_dtype=self.compute_dtype, mesh=mesh)

    def prepare(self, img: np.ndarray) -> np.ndarray:
        if self.presets.resize:
            img = iio.linear_resize(img, self.presets.resize, device=self.device)
        if self.presets.use_modcrop:
            img = iio.modcrop(img, 4)
        return img

    def forward(self, t_img: torch.Tensor, *, force_whole: bool = False) -> torch.Tensor:
        """The chain on an (N, H, W, C) device tensor: each stage on the
        whole image in turn (``force_whole``: untiled, see
        :meth:`Stage.__call__`), and after each, where the preset asks for
        it (WBC), the guided filter against the input (run.py:425-429); or
        the fused chain's tile pass."""
        if self._fused_runner is not None:
            return self._fused_runner(None, t_img)
        t_out = t_img
        for stage in self.stages:
            t_out = stage(t_out, force_whole=force_whole)
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
        with span("innfer.frame", self.device, root=True):
            with span("innfer.upload", self.device):
                if not already_prepared:
                    img = self.prepare(img)
                t_img = np2tensor(img, normalize=self.presets.normalize,
                                  dtype=self.compute_dtype, device=self.device)
            if color_ref is not None:
                color_ref = color_ref.reshape(color_ref.shape[:2] + (-1,))
            u8 = _to_u8(self.forward(t_img), color_ref, denormalize=self.presets.normalize)
            out = HostCopy.start(u8)
            return out if host_copy else out.fetch()

    # -- batched directory mode (innfer_tpu/pipeline.py:681-881) -----------

    def batchable(self, shape: Sequence[int], n: int) -> bool:
        """Whether ``n`` stacked images of prepared HWC ``shape`` can run as
        one whole-image forward within the memory budget, checked at every
        stage's input resolution; no limit on the CPU."""
        if n <= 1:
            return False
        budget = whole_image_budget(self.device)
        if budget is None:
            return True
        h, w = int(shape[0]), int(shape[1])
        c = int(shape[2]) if len(shape) > 2 else 1
        for st in self.stages:
            if _whole_forward_bytes(st.model, (n, h, w, c)) > budget:
                return False
            h, w = h * st.model.scale, w * st.model.scale
            c = int(st.model.cfg.get("out_nc", 3))
        return True

    def batchable_tiled(self, shape: Sequence[int], n: int) -> bool:
        """Whether ``n`` stacked images can run through the tiled engine
        (cross-image tile stacking).  A dispatch group's activations stay
        bounded by the engine's group-pixel cap whatever ``n`` is; what
        grows with ``n`` are the resident canvases (input stack, fp32 tiles
        and recompose canvas, output), the JAX package's 24 bytes per
        output pixel, with 2 GB kept for the group's activations."""
        if n <= 1:
            return False
        budget = whole_image_budget(self.device)
        if budget is None:
            return True
        out_px = n * int(shape[0]) * int(shape[1]) * self.total_scale ** 2
        return out_px * 24 < budget - 2 * 1024 ** 3

    def _group_fits(self, shape: Sequence[int], n: int) -> bool:
        # run_batch's path order: whole-image stacking, then tiled stacking
        # for chopped presets
        if self.batchable(shape, n):
            return True
        return self.presets.chop and self.batchable_tiled(shape, n)

    def auto_batch(self, shape: Sequence[int], cap: int = 0) -> int:
        """The group size of ``batch=0``: the largest power of 2 up to
        ``cap`` (default ``INNFER_MAX_BATCH``, 32) whose stack fits."""
        cap = cap or int(os.environ.get("INNFER_MAX_BATCH", "32"))
        n = 1
        while n * 2 <= cap and self._group_fits(shape, n * 2):
            n *= 2
        return n

    def run_batch(self, imgs: List[np.ndarray], *, already_prepared: bool = False,
                  use_color_fix: bool = False, host_copy: bool = False) -> list:
        """Run N images as one stacked forward where they allow it; returns
        one output per image, numpy or (``host_copy``) :class:`HostCopy`.

        Path order, as the JAX package's: same-shape images that fit the
        budget run one whole-image stacked forward (a fused-chain session
        excepted, whose images all stay on its tile pass); else a chopped
        preset without TorchScript stacks their tiles in shared dispatch
        groups (``tiling/engine.tiled_apply``); else each image runs alone.
        Per-image outputs equal the solo forwards' up to summation order:
        convs and instance norm act per image, and train-mode batch norm
        takes per-image statistics (``nn/functional.batch_norm``).  A CycleGAN
        stack runs whole-image, so its instance norm takes whole-image
        statistics, where a lone image runs tiled with per-tile ones, as
        in the JAX package.

        On a mesh whose model axis is 1, a whole-image stack that divides by
        the data-axis size is split over the data devices (one slice of
        images each) and gathered before the u8 rounding; a tiled stack
        splits its own tile groups.  A spatial session stacks no tiles: its
        runner shards one image."""
        if not already_prepared:
            imgs = [self.prepare(im) for im in imgs]
        imgs = [im[:, :, None] if im.ndim == 2 else im for im in imgs]
        n = len(imgs)
        same = all(im.shape == imgs[0].shape and im.dtype == imgs[0].dtype for im in imgs)
        whole_ok = (same and self._fused_runner is None
                    and self.batchable(imgs[0].shape, n))
        tiled_ok = (not whole_ok and same and self.presets.chop and not self._spatial
                    and not self.has_torchscript and self.batchable_tiled(imgs[0].shape, n))
        if not whole_ok and not tiled_ok:
            return [self.run_image(im, already_prepared=True, host_copy=host_copy,
                                   color_ref=im if use_color_fix else None)
                    for im in imgs]
        with span("innfer.upload", self.device):
            stacked = np.stack(imgs)
            t_img = np2tensor(stacked, normalize=self.presets.normalize,
                              dtype=self.compute_dtype, device=self.device)
        mesh = self._mesh
        if (whole_ok and mesh is not None and mesh.shape.get("model", 1) == 1
                and n % mesh.shape.get("data", 1) == 0):
            # image-level dp: the images are independent, each data device
            # runs its slice of the stack with its replicated params
            t_out = data_parallel(lambda t: self.forward(t, force_whole=True), t_img, mesh)
        else:
            t_out = self.forward(t_img, force_whole=whole_ok)
        u8 = _to_u8(t_out, stacked if use_color_fix else None,
                    denormalize=self.presets.normalize, batched=True)
        outs = HostCopy.start(u8).split()
        return outs if host_copy else [o.fetch() for o in outs]

    def process(self, input_dir: str, output_dir: str, *, use_color_fix: bool = False,
                comp: bool = False, verbose: bool = True, shard_index: int = 0,
                num_shards: int = 1, metrics_dir: Optional[str] = None, timers=None,
                batch: int = 1) -> List[str]:
        """Process a directory of images; returns the written paths.

        Upcoming images decode ahead while the device works, on the native
        runtime's threads (``runtime/native.PrefetchLoader``; files it
        cannot read, such as TIFF, WEBP, BMP or DNG, decode through OpenCV
        on this thread), or through OpenCV on two Python threads where its
        library is unavailable; finished outputs are fetched and
        PNG-encoded on a background pool of ``INNFER_ENCODE_THREADS``
        threads (default 2; 0 encodes inline).
        ``use_color_fix`` (-cf) transfers the prepared input's color to
        the output on the device; ``comp`` (-comp) writes the prepared
        input and the output side by side.  ``shard_index``/``num_shards``
        stripe the work list (``parallel/multihost.shard_paths``);
        ``metrics_dir`` holds each output against the same-named ground
        truth (PSNR/SSIM, on the host; rows in ``self.last_metrics``);
        ``timers`` (``observability.StageTimers``) times the ``read``,
        ``image``/``batch``, ``encode_wait``, ``fetch`` and ``encode``
        stages.  Each stage is the tracer's span ``innfer.<stage>``, with
        or without timers; each image takes a request id after its read, which
        its ``image`` span and, on the encode threads, its ``fetch`` and
        ``encode`` spans carry, and a group's ``batch`` span carries the
        tuple of its images' ids.

        ``batch > 1`` groups same-shape prepared images and runs each full
        group through :meth:`run_batch`; ``batch=0`` sizes each shape's
        group with :meth:`auto_batch`.  Groups left at the end of the
        directory run at their natural size.  Write errors surface at the
        end-of-run drain; on any error the queued work is cancelled and
        the encode pool is shut down and the loader closed."""
        paths = shard_paths(iio.get_images_paths(input_dir), shard_index, num_shards)
        written: List[str] = []
        metric_rows: List[dict] = []
        n_enc = int(os.environ.get("INNFER_ENCODE_THREADS", "2"))
        loader = PrefetchLoader(paths, fallback=lambda p: iio.read_img(p, use_native=False))
        enc_pool = (ThreadPoolExecutor(max_workers=n_enc, thread_name_prefix="innfer-encode")
                    if n_enc > 0 else None)
        encodes: Deque = deque()

        def finalize(out: HostCopy, dst: str, name: str, src: str, img_in: np.ndarray,
                     rid: int):
            img = out.fetch(timers, request=rid)
            with stage(timers, "encode", request=rid):
                if comp:
                    iio.save_img_comp([img_in, img], dst)
                else:
                    iio.save_img(img, dst)
            if metrics_dir:
                gt = _find_reference(metrics_dir, name)
                if gt is not None and gt.shape != img.shape:
                    # presets that resize or modcrop the input change the
                    # output's geometry against a same-named ground truth
                    print(f"  metrics {name}: skipped — ground truth {gt.shape} != "
                          f"output {img.shape} (the preset resized/modcropped the input)")
                elif gt is not None:
                    row = {"image": name, "psnr": round(psnr_np(img, gt), 3),
                           "ssim": round(ssim_np(img.astype(np.float32) / 255.0,
                                                 gt.astype(np.float32) / 255.0), 4)}
                    metric_rows.append(row)
                    if verbose:
                        print(f"  metrics {name}: PSNR {row['psnr']} dB, SSIM {row['ssim']}")
            if verbose:
                print(f"{src} -> {dst} {img.shape[1]}x{img.shape[0]}")

        def finish(name: str, src: str, img_in: np.ndarray, out: HostCopy, rid: int):
            dst = osp.join(output_dir, f"{name}.png")
            written.append(dst)
            if enc_pool is None:
                finalize(out, dst, name, src, img_in, rid)
                return
            # bound the outputs in flight: each holds a full output image
            # in pinned host memory
            while len(encodes) >= max(4, 2 * n_enc):
                with stage(timers, "encode_wait", request=rid):
                    encodes.popleft().result()
            encodes.append(enc_pool.submit(finalize, out, dst, name, src, img_in, rid))

        def flush(group):
            names, srcs, imgs, rids = zip(*group)
            # one "batch" sample per group: its time per image is the
            # total over the group's size
            with stage(timers, "batch", device=self.device, request=rids):
                outs = self.run_batch(list(imgs), already_prepared=True,
                                      use_color_fix=use_color_fix, host_copy=True)
            for name, src, img_in, out, rid in zip(names, srcs, imgs, outs, rids):
                finish(name, src, img_in, out, rid)

        targets = {}   # shape key -> group size
        pending = {}   # shape key -> the images of its open group
        try:
            images = iter(loader)
            for _ in paths:
                with stage(timers, "read"):  # the wait for the next decoded image
                    _, src, img = next(images)
                if img is None:
                    print(f"Error reading image {src}, skipping.")
                    continue
                rid = TRACER.new_request()
                name = osp.splitext(osp.basename(src))[0]
                img_in = self.prepare(img)
                key = (img_in.shape, str(img_in.dtype))
                if key not in targets:
                    targets[key] = (batch if batch > 1 else
                                    self.auto_batch(img_in.shape) if batch == 0 else 1)
                if targets[key] > 1:
                    group = pending.setdefault(key, [])
                    group.append((name, src, img_in, rid))
                    if len(group) == targets[key]:
                        flush(group)
                        pending[key] = []
                    continue
                with stage(timers, "image", request=rid):
                    out = self.run_image(img_in, already_prepared=True, host_copy=True,
                                         color_ref=img_in if use_color_fix else None)
                finish(name, src, img_in, out, rid)
            for group in pending.values():
                if group:
                    flush(group)
            while encodes:
                encodes.popleft().result()  # surface write errors
        except BaseException:
            for f in encodes:
                f.cancel()
            raise
        finally:
            loader.close()
            if enc_pool is not None:
                enc_pool.shutdown(wait=True)
        if metric_rows and verbose:
            mean_p = sum(r["psnr"] for r in metric_rows) / len(metric_rows)
            mean_s = sum(r["ssim"] for r in metric_rows) / len(metric_rows)
            print(f"metrics mean over {len(metric_rows)}: PSNR {mean_p:.3f} dB, "
                  f"SSIM {mean_s:.4f}")
        self.last_metrics = metric_rows
        return written
