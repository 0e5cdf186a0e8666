"""The general traffic generator: every mix is a data file,
``innbench/traffic/<mix>.json``, of one of two kinds.

``frames``: a closed loop of one caller sending in-memory u8 frames of
``height`` x ``width`` to ``InferenceSession.run_image``, cycling through a
ring of ``ring`` frames.

``dir``: repeated ``InferenceSession.process`` passes over a directory of
PNG files; ``sizes`` lists [height, width, count] triples, so every seed
gets the same images in another order; ``warmup`` is ``one_per_shape`` (a
pass over one image of each size) or ``full_pass`` (a pass over the whole
directory, for programs that group images by shape).

Both draw their images with the same recipe, from the seed: smooth
structure, mild noise of ``noise_std`` levels, and a stripe pattern that pans
by 57 pixels from one image to the next.  Pure noise would make the PNG
encode pathologically slow and flat fields would make it free.  ``sample``
is how many outputs the run compares with the reference.
"""
from __future__ import annotations

import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from innbench import png

KINDS = ("frames", "dir")


def images(h: int, w: int, indices, noise_std: float, gen: torch.Generator,
           device) -> np.ndarray:
    """(n, h, w, 3) u8 RGB: one image for each pan index in ``indices``."""
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    base = 127 + 90 * torch.sin(xx / 37.0) * torch.cos(yy / 23.0)
    out = np.empty((len(indices), h, w, 3), np.uint8)
    for j, i in enumerate(indices):
        noise = torch.randn((h, w, 3), generator=gen, device=device) * noise_std
        img = base[..., None] + noise + (20 * torch.sin((xx + 57 * i) / 11.0))[..., None]
        out[j] = img.clamp(0, 255).to(torch.uint8).cpu().numpy()
    return out


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def make_frames(traffic: dict, seed: int, device) -> np.ndarray:
    """The ring of frames, (ring, h, w, 3) u8 RGB."""
    return images(traffic["height"], traffic["width"], range(traffic["ring"]),
                  traffic["noise_std"], generator(seed, device), device)


def dir_plan(traffic: dict, seed: int) -> List[Tuple[str, int, int, int]]:
    """(file name, height, width, pan index) of every image of the
    directory; the names, and so the order ``process`` reads them in, are a
    permutation drawn from the seed."""
    entries = [(h, w) for h, w, n in traffic["sizes"] for _ in range(n)]
    order = np.random.default_rng(seed).permutation(len(entries))
    return [(f"img{int(rank):03d}", h, w, i)
            for i, ((h, w), rank) in enumerate(zip(entries, order))]


def write_dir(traffic: dict, seed: int, path: str, device) -> Dict[str, np.ndarray]:
    """Write the directory's PNGs into ``path``; returns name -> u8 RGB image."""
    os.makedirs(path, exist_ok=True)
    gen = generator(seed, device)
    imgs = {name: images(h, w, [i], traffic["noise_std"], gen, device)[0]
            for name, h, w, i in dir_plan(traffic, seed)}
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(lambda kv: png.write(osp.join(path, kv[0] + ".png"), kv[1]),
                      imgs.items()))
    return imgs


def warm_names(traffic: dict, seed: int) -> List[str]:
    """The images of the warm-up pass: the whole directory, or the first of
    each size in processing order."""
    plan = sorted(dir_plan(traffic, seed))
    if traffic["warmup"] == "full_pass":
        return [name for name, *_ in plan]
    if traffic["warmup"] != "one_per_shape":
        raise ValueError(f"unknown warmup {traffic['warmup']!r}")
    seen, out = set(), []
    for name, h, w, _ in plan:
        if (h, w) not in seen:
            seen.add((h, w))
            out.append(name)
    return out
