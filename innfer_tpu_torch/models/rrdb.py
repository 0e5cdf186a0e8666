"""RRDBNet (ESRGAN / ESRGAN+ / mESRGAN) in PyTorch, NHWC.

The port's counterpart of ``innfer_tpu/models/rrdb.py`` (2-D, reference
RRDBNet_arch.py:16-198): fea conv -> ShortcutBlock(nb x RRDB + LR conv) ->
upsample chain -> HR convs (+ optional final act).  An RRDB is nr
ResidualDenseBlock_5C with out*0.2 + x; mESRGAN checkpoints are remapped
to the flattened layout (remaps.mod_to_normal) and run the same forward.

An RDB runs on the fused CUDA kernel (ops/rdb.py) wherever
``rdb.fusable`` holds (a CUDA tensor, fp32 or bf16, biased convs,
LeakyReLU and no norm layers), else on the plain gather form
(:func:`_rdb5c`): norm layers and prelu/swish take the plain path, as they
take XLA's in the JAX package.  With ``INNFER_RDB_CHAIN=1`` in the
environment (read at each trunk call, default off, as in the JAX package)
a trunk whose RDBs are fusable runs as one ``fused_rrdb_trunk``: nb*nr
chain-mode RDB launches on persistent workspaces, each RRDB's residual
fused into its last RDB.

Both residuals multiply by 0.2 in the activation dtype (``res_scale``), as
the JAX package's ``jnp.asarray(0.2, x.dtype)`` does.  The tail takes the
JAX package's structure (``innfer_tpu/models/rrdb.py:304-326``, run by
``common.sr_tail``): upconv blocks LR-collapsed and the last block with
the HR convs in phase space where the predicates of ``models/common.py``
say.  evsrgan (convtype 'Conv3D', :func:`_build_3d`) runs every conv as a
Conv3d on NDHWC clips, at the library level only.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch

from innfer_tpu_torch.checkpoint.remaps import mod_to_normal
from innfer_tpu_torch.models import common as C
from innfer_tpu_torch.models.base import ModelDef, cached
from innfer_tpu_torch.models.common import _outm
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.nn import resize as R
from innfer_tpu_torch.ops import rdb as RDB
from innfer_tpu_torch.ops.rdb import PackedRDB, fused_rdb, fused_rrdb_trunk, pack_rdb, res_scale

_PLAIN_ACTS = ("relu", "leakyrelu", "lrelu", "tanh", "sigmoid")


def _rdb5c(params, x: torch.Tensor, prefix: str, *, act_type: str,
           plus: bool, norm_type=None, conv_fn=None) -> torch.Tensor:
    """Residual Dense Block, plain gather form: 5 dense-concat conv blocks
    (always CNA: RRDBNet passes mode='CNA' to its RRDBs, RRDBNet_arch.py:27;
    conv5 without act), ESRGAN+ conv1x1 cross-residuals, out*0.2 + x.
    ``conv_fn(t, w, b)`` replaces the conv blocks by bare convs + act
    (Conv3D for evsrgan)."""
    cat = lambda *ts: torch.cat(ts, dim=-1)  # noqa: E731

    def cb(i, t, act):
        if conv_fn is not None:
            t = conv_fn(t, params[f"{prefix}.conv{i}.0.weight"],
                        params.get(f"{prefix}.conv{i}.0.bias"))
            return F.act(act_type, t) if act else t
        return C.apply_conv_block(
            params, t, lambda j: f"{prefix}.conv{i}.{j}", mode="CNA",
            norm_type=norm_type, act_type=act_type if act else None)

    x1 = cb(1, x, True)
    x2 = cb(2, cat(x, x1), True)
    if plus:
        x2 = x2 + F.conv2d(x, params[f"{prefix}.conv1x1.weight"])
    x3 = cb(3, cat(x, x1, x2), True)
    x4 = cb(4, cat(x, x1, x2, x3), True)
    if plus:
        x4 = x4 + x2
    x5 = cb(5, cat(x, x1, x2, x3, x4), False)
    return x5 * res_scale(x.dtype) + x


def _rdb_params(params, prefix: str, plus: bool):
    weights = [params.get(f"{prefix}.conv{c}.0.weight") for c in range(1, 6)]
    biases = [params.get(f"{prefix}.conv{c}.0.bias") for c in range(1, 6)]
    w1 = params[f"{prefix}.conv1x1.weight"] if plus else None
    return weights, biases, w1


def _packed(params, prefix: str, x: torch.Tensor, plus: bool) -> PackedRDB:
    """The kernel layout of one RDB's weights, cached per activation dtype
    and device."""
    return cached(params, ("rdb", prefix, x.dtype, x.device),
                  lambda: pack_rdb(*_rdb_params(params, prefix, plus), x.dtype))


def _rdb5c_kernel(params, x: torch.Tensor, prefix: str, *,
                  plus: bool) -> torch.Tensor:
    """The fused RDB; its packed weights are cached on the ParamDict."""
    weights, biases, w1 = _rdb_params(params, prefix, plus)
    return fused_rdb(x.contiguous(), weights, biases, plus=plus,
                     conv1x1_w=w1, packed=_packed(params, prefix, x, plus))


def _fusable(params, x: torch.Tensor, prefix: str, *, act_type: str, norm_type) -> bool:
    """``rdb.fusable`` for the RDB at ``prefix``."""
    weights, biases, _ = _rdb_params(params, prefix, False)
    return RDB.fusable(x, weights, biases, act_type=act_type, norm_type=norm_type)


def _rdb_names(nr: int):
    # nr != 3 checkpoints name their RDBs 'RDBs.{i}' (reference RRDB)
    return (("RDB1", "RDB2", "RDB3") if nr == 3
            else tuple(f"RDBs.{i}" for i in range(nr)))


def _rrdb(params, x: torch.Tensor, prefix: str, *, nr: int, act_type: str,
          plus: bool, norm_type=None, conv_fn=None) -> torch.Tensor:
    out = x
    for name in _rdb_names(nr):
        p = f"{prefix}.{name}"
        if _fusable(params, out, p, act_type=act_type, norm_type=norm_type):
            out = _rdb5c_kernel(params, out, p, plus=plus)
        else:
            out = _rdb5c(params, out, p, act_type=act_type, plus=plus,
                         norm_type=norm_type, conv_fn=conv_fn)
    return out * res_scale(x.dtype) + x


def _use_chain(params, x: torch.Tensor, *, nr: int, act_type: str, norm_type) -> bool:
    """The chain gate of innfer_tpu/models/rrdb.py:270-276: opted in with
    INNFER_RDB_CHAIN=1, and the trunk's first RDB fusable."""
    return (os.environ.get("INNFER_RDB_CHAIN", "0") == "1"
            and _fusable(params, x, f"model.1.sub.0.{_rdb_names(nr)[0]}",
                         act_type=act_type, norm_type=norm_type))


def _trunk_chain(params, x: torch.Tensor, *, nb: int, nr: int,
                 plus: bool) -> torch.Tensor:
    """nb RRDBs as one fused_rrdb_trunk, its weights collected by the keys
    of innfer_tpu/models/rrdb.py:280-289."""
    prefixes = [[f"model.1.sub.{i}.{n}" for n in _rdb_names(nr)] for i in range(nb)]
    per_rdb = [[_rdb_params(params, p, plus) for p in row] for row in prefixes]
    weights = [[wb[0] for wb in row] for row in per_rdb]
    biases = [[wb[1] for wb in row] for row in per_rdb]
    w1s = [[wb[2] for wb in row] for row in per_rdb] if plus else None
    packed = [[_packed(params, p, x, plus) for p in row] for row in prefixes]
    return fused_rrdb_trunk(x.contiguous(), weights, biases, nb=nb, nr=nr,
                            gc=weights[0][0][0].shape[0], plus=plus,
                            conv1x1_ws=w1s, packed=packed)


def build(cfg: Dict[str, Any]) -> ModelDef:
    """Build the RRDBNet ModelDef from a full config (config/defaults.py)."""
    nb = cfg["nb"]
    nr = cfg.get("nr", 3)
    upscale = int(cfg.get("upscale", 4))
    act_type = cfg.get("act_type", "leakyrelu")
    plus = bool(cfg.get("plus", False))
    up_mode = cfg.get("upsample_mode", "upconv")
    finalact = cfg.get("finalact")
    outm = cfg.get("outm")
    norm_type = cfg.get("norm_type")
    if norm_type == "none":
        norm_type = None
    conv_mode = cfg.get("mode", "CNA")
    if norm_type not in (None, "batch", "instance"):
        raise NotImplementedError(f"normalization layer [{norm_type}] is not found")
    convtype = cfg.get("convtype", "Conv2D")
    if convtype not in ("Conv2D", "Conv3D"):
        raise NotImplementedError(f"convtype {convtype} not supported")
    if convtype == "Conv3D":
        return _build_3d(cfg, nb=nb, nr=nr, act_type=act_type, plus=plus,
                         up_mode=up_mode, norm_type=norm_type, upscale=upscale,
                         finalact=finalact, outm=outm)

    def apply_trunk(params, x: torch.Tensor) -> torch.Tensor:
        """fea conv -> nb RRDBs -> LR conv -> shortcut sum: the whole
        LR-resolution part of the model (96+% of FLOPs), split out so the
        hybrid engine can run it untiled on the full image."""
        fea = C.conv3x3(params, x, "model.0")
        t = fea
        if _use_chain(params, t, nr=nr, act_type=act_type, norm_type=norm_type):
            t = _trunk_chain(params, t, nb=nb, nr=nr, plus=plus)
        else:
            for i in range(nb):
                t = _rrdb(params, t, f"model.1.sub.{i}", nr=nr, act_type=act_type,
                          plus=plus, norm_type=norm_type)
        # LR_conv: mode/norm-dependent layout, flattened into the trunk
        # sequential at positional base nb (RRDBNet_arch.py:29)
        t = C.apply_conv_block(params, t, lambda j: f"model.1.sub.{nb + j}",
                               mode=conv_mode, norm_type=norm_type, act_type=None)
        return fea + t  # ShortcutBlock (block.py:183-194)

    def apply_tail(params, h: torch.Tensor) -> torch.Tensor:
        return _outm(C.sr_tail(params, h, "model", upscale=upscale, up_mode=up_mode,
                               act_type=act_type, finalact=finalact), outm)

    def apply(params, x: torch.Tensor) -> torch.Tensor:
        return apply_tail(params, apply_trunk(params, x))

    return ModelDef(
        name="rrdb_net",
        cfg=dict(cfg),
        apply=apply,
        scale=upscale,
        apply_trunk=apply_trunk,
        apply_tail=apply_tail,
        # upsample-chain receptive radius in LR px: each block's 3x3 conv
        # adds 1/prod(earlier factors), the phase tail's HR convs <= 1 more;
        # 4 covers every scale (1/2/4/8)
        tail_halo=4,
        # the fused RDB runs on the card in this configuration (the JAX
        # package's tile_quantum condition, rrdb.py:336-338)
        trunk_kernel=RDB.config_ok(act_type, norm_type),
    )


def _build_3d(cfg, *, nb, nr, act_type, plus, up_mode, norm_type, upscale,
              finalact, outm) -> ModelDef:
    """evsrgan: RRDBNet with Conv3d everywhere, on NDHWC video clips
    (``innfer_tpu/models/rrdb.py:355-410``).  The reference builds every
    conv_block as nn.Conv3d k3/pad1 (block.py:232-234) and upconv blocks
    nearest-upsample by (1, 2, 2), depth untouched (block.py:357).  Its CLI
    cannot feed a 5-D clip, so the model is reached through the library
    (``loader`` + ``model.apply``); ``InferenceSession`` refuses it.  No
    port kernel runs on this path."""
    if plus:
        raise NotImplementedError(
            "evsrgan plus: the reference conv1x1 is nn.Conv2d "
            "(block.py:390-391) and crashes on 5D inputs")
    if norm_type not in (None, "none"):
        raise NotImplementedError(
            "evsrgan norm layers: reference norm() builds 2D norms "
            "(block.py:112-132) which crash on 5D inputs")
    if up_mode != "upconv":
        raise NotImplementedError("evsrgan supports upconv upsampling only")
    if act_type not in _PLAIN_ACTS:
        raise NotImplementedError(
            f"evsrgan act {act_type!r}: only parameter-free activations "
            "are supported on the Conv3D path")

    _n_up, factor = C.n_upscale_blocks(upscale)
    up_convs, hr0 = C.upsample_indices(upscale, up_mode)
    conv3 = lambda t, w, b=None: F.conv3d(t, w, b, padding=1)  # noqa: E731

    def apply(params, x: torch.Tensor) -> torch.Tensor:
        g = lambda k: (params[f"{k}.weight"], params.get(f"{k}.bias"))  # noqa: E731
        fea = conv3(x, *g("model.0"))
        t = fea
        for i in range(nb):
            t = _rrdb(params, t, f"model.1.sub.{i}", nr=nr, act_type=act_type,
                      plus=False, conv_fn=conv3)
        h = fea + conv3(t, *g(f"model.1.sub.{nb}"))
        for ci in up_convs:
            b_, d, hh, ww, c = h.shape
            u = R.upsample_nearest(h.reshape(b_ * d, hh, ww, c), factor)
            h = F.act(act_type, conv3(u.reshape(b_, d, hh * factor, ww * factor, c),
                                      *g(f"model.{ci}")))
        h = F.act(act_type, conv3(h, *g(f"model.{hr0}")))
        h = conv3(h, *g(f"model.{hr0 + 2}"))
        if finalact:
            h = F.act(finalact, h)
        return _outm(h, outm)

    return ModelDef(name="rrdb_net", cfg=dict(cfg), apply=apply, scale=upscale)


def build_mrrdb(cfg: Dict[str, Any]) -> ModelDef:
    """mESRGAN: fixed-4x modified-layout RRDB, remapped to the flattened
    layout and run through the rrdb forward."""
    full = {
        "type": "rrdb_net",
        "nb": cfg["nb"],
        "nr": 3,
        "nf": cfg.get("nf", 64),
        "gc": cfg.get("gc", 32),
        "in_nc": cfg.get("in_nc", 3),
        "out_nc": cfg.get("out_nc", 3),
        "upscale": 4,
        "act_type": "leakyrelu",
        "upsample_mode": "upconv",
        "norm_type": None,
        "plus": False,
    }
    model = build(full)
    model.name = "mrrdb_net"
    model.remap = mod_to_normal
    return model
