"""Host-side image I/O, directory scanning and the geometry helpers
modcrop and linear_resize: the port's counterpart of
``innfer_tpu/io/images.py`` (reference utils/utils.py:17-133, 251-275).

Images are numpy HWC BGR uint8/uint16, as OpenCV keeps them.  As in the
JAX package, the native codec (runtime/native.py) reads PNG (and JPEG
where it was built with libjpeg) and writes 8-bit PNG where its library
builds; OpenCV takes the rest where it
can be imported; elsewhere the stdlib PNG codec (io/png.py) reads and
writes 8-bit PNG, and other formats raise.  The resizes need no OpenCV:
``linear_resize`` runs the port's bicubic (``nn/resize.interpolate``) on a
torch device, and ``merge_imgs`` and ``save_img(scale=)`` index the
nearest rows and columns.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import List, Optional, Sequence

import numpy as np
import torch

from innfer_tpu_torch.io import png
from innfer_tpu_torch.nn import resize as R
from innfer_tpu_torch.ops import colors
from innfer_tpu_torch.runtime import native

try:
    import cv2
except ImportError:  # a machine without OpenCV takes the stdlib PNG codec
    cv2 = None

try:  # DNG raw support is optional, as in the reference (utils.py:10-14)
    import rawpy
except ImportError:
    rawpy = None

MODEL_EXTENSIONS = (".pth", ".pt")
IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp", "tga", ".tif", ".tiff", ".dng",
)

MAX_VALUES_BY_DTYPE = {
    np.dtype("int8"): 127,
    np.dtype("uint8"): 255,
    np.dtype("int16"): 32767,
    np.dtype("uint16"): 65535,
    np.dtype("int32"): 2147483647,
    np.dtype("uint32"): 4294967295,
    np.dtype("int64"): 9223372036854775807,
    np.dtype("uint64"): 18446744073709551615,
    np.dtype("float32"): 1.0,
    np.dtype("float64"): 1.0,
}


def codec_name() -> str:
    """What reads and writes images here, as ``native (zlib 1.3; PNG) +
    opencv 4.13.0``: the native codec where its library builds (with the
    formats it reads), then OpenCV, or the stdlib PNG codec without it."""
    rest = f"opencv {cv2.__version__}" if cv2 is not None else "stdlib png"
    return f"native ({native.version()}) + {rest}" if native.available() else rest


def scan_dir(path: str, extensions: Sequence[str] = IMG_EXTENSIONS) -> List[str]:
    if not osp.isdir(path):
        raise AssertionError(f"{path} is not a valid directory")
    found = []
    for dirpath, _, fnames in sorted(os.walk(path)):
        for fname in sorted(fnames):
            if any(fname.endswith(ext) for ext in extensions):
                found.append(osp.join(dirpath, fname))
    return found


def get_models_paths(path: str) -> List[str]:
    models = scan_dir(path, MODEL_EXTENSIONS)
    if not models:
        raise AssertionError(f"{path} has no valid model file")
    return models


def get_images_paths(path: str) -> List[str]:
    images = scan_dir(path, IMG_EXTENSIONS)
    if not images:
        raise AssertionError(f"{path} has no valid image file")
    return images


def _no_codec(path: str) -> ValueError:
    why = native.unavailable_reason()
    reads = "PNG and JPEG" if why is None and native.has_jpeg() else "PNG"
    nat = (f"the native codec reads {reads} and writes 8-bit PNG" if why is None
           else f"the native codec is unavailable ({why})")
    return ValueError(f"{path}: no codec for this file: OpenCV is not installed, {nat}, "
                      "and the stdlib codec handles 8-bit PNG only")


def read_img(path: str, use_native: bool = True) -> Optional[np.ndarray]:
    """Read an image as numpy HWC BGR (uint8/uint16), like the reference;
    None when no codec can decode it.  A ``.dng`` goes through rawpy where
    it is installed, whose ``postprocess()`` array is returned as it is,
    as the reference and the JAX package return it; then the native codec
    (PNG, and JPEG where libjpeg is built in; skipped with
    ``use_native=False``), OpenCV, and the stdlib
    PNG codec where OpenCV is missing."""
    if not path:
        raise AssertionError("Empty path provided.")
    if rawpy is not None and path[-3:].lower() == "dng":
        with rawpy.imread(path) as raw:
            return raw.postprocess()
    if use_native:
        img = native.decode(path)
        if img is not None:
            return img
    if cv2 is not None:
        return cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if not path.lower().endswith(".png"):
        raise _no_codec(path)
    return png.read(path)


def save_img(img: np.ndarray, img_path: str, scale: Optional[float] = None) -> None:
    """Write ``img`` (HWC BGR or HW gray) to ``img_path``, first resized by
    ``scale`` as ``cv2.resize(fx=fy=scale, INTER_NEAREST)`` resizes it (the
    JAX package's ``scale=``): 8-bit PNG through the native codec, else
    OpenCV, else the stdlib PNG codec."""
    if scale:
        h, w = img.shape[:2]
        img = img[R.nearest_table(round(h * scale), h, 1.0 / scale)][
            :, R.nearest_table(round(w * scale), w, 1.0 / scale)]
    os.makedirs(osp.dirname(osp.abspath(img_path)), exist_ok=True)
    if img_path.lower().endswith(".png") and native.encode_png(img_path, img):
        return
    if cv2 is not None:
        if not cv2.imwrite(img_path, img):
            # imwrite reports failure by return value only
            raise OSError(f"failed to write image {img_path}")
        return
    if not img_path.lower().endswith(".png"):
        raise _no_codec(img_path)
    png.write(img_path, img)


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H, W down to multiples of ``scale`` (utils.py:251-264)."""
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale, ...]


def merge_imgs(img_list) -> np.ndarray:
    """Concatenate side by side, nearest-upscaling the smaller entries to
    the largest height and width (reference utils.py:98-117), with the
    source index floor(dst * in / out) of ``cv2.INTER_NEAREST``."""
    if isinstance(img_list, np.ndarray):
        return img_list
    if not isinstance(img_list, list):
        raise NotImplementedError("img_list should be a list of HWC images")
    max_h = max(im.shape[0] for im in img_list)
    max_w = max(im.shape[1] for im in img_list)
    return np.concatenate(
        [im[R.nearest_table(max_h, im.shape[0])][:, R.nearest_table(max_w, im.shape[1])]
         for im in img_list], axis=1)


def save_img_comp(img_list, img_path: str) -> None:
    save_img(merge_imgs(img_list), img_path)


def linear_resize(img: np.ndarray, st: int = 256,
                  device: Optional[torch.device] = None) -> np.ndarray:
    """Enlarge H and W to the next multiples of ``st`` through linear
    light (reference utils.py:267-275): sRGB -> linear, bicubic, linear ->
    sRGB uint8 (the cast truncates), computed in fp32 on ``device`` (the
    CPU by default; the session passes its own, so only u8 pixels cross
    the bus).  An image whose sides are already multiples is returned as
    it is.

    The bicubic is ``nn/resize.interpolate`` (A = -0.75, half-pixel
    centres, clamped border), which is what the JAX package's
    ``cv2.INTER_CUBIC`` computes when it enlarges."""
    h, w = img.shape[:2]
    if h % st == 0 and w % st == 0:
        return img
    oh, ow = -(-h // st) * st, -(-w // st) * st
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device).reshape(h, w, -1)
    linear = R.interpolate(colors.srgb_to_linear(x)[None], size=(oh, ow), mode="bicubic",
                           align_corners=False)[0]
    return colors.linear_to_srgb(linear).reshape((oh, ow) + img.shape[2:]).cpu().numpy()
