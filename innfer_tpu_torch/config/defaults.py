"""Network-config normalizer: alias resolution + per-arch hyperparameter
defaults.

The port's own copy of ``innfer_tpu/config/defaults.py``; the reference is
``get_network_G_config`` (utils/defaults.py:3-148): the same alias sets
and defaults (esrgan-lite nf/nb, evsrgan Conv3D, unet_128/p2p_128 seven
downs, resnet_6/9 n_blocks, the wbcunet tf mode).
"""
from __future__ import annotations

from typing import Any, Dict, Union


def _match_kind(kind: str) -> str:
    """Resolve an arch alias to its canonical factory type."""
    if kind in ("rrdb_net", "esrgan", "evsrgan", "esrgan-lite"):
        return "rrdb_net"
    if kind in ("mrrdb_net", "mesrgan"):
        return "mrrdb_net"
    if kind in ("sr_resnet", "srresnet", "srgan"):
        return "sr_resnet"
    if "ppon" in kind:
        return "ppon"
    if "swinir" in kind:
        return "swinir"
    if kind == "hat":
        return "hat"
    if kind in ("pan_net", "pan"):
        return "pan_net"
    if "wbcunet" in kind:
        return "wbcunet_net"
    if "unet" in kind or "p2p" in kind:
        return "unet_net"
    if ("resnet" in kind and kind != "sr_resnet") or "cg" in kind:
        return "resnet_net"
    raise NotImplementedError(f"Generator model [{kind}] not recognized")


def get_network_config(network: Union[str, Dict[str, Any]], scale: int) -> Dict[str, Any]:
    """Fill per-architecture defaults for a (possibly partial) network spec:
    the same alias sets and default values as the reference (esrgan-lite
    nf/nb, evsrgan Conv3D)."""
    scale = int(scale)
    if isinstance(network, str):
        kind = network.lower()
        opts: Dict[str, Any] = {}
    else:
        opts = dict(network)
        key = "which_model_G" if "which_model_G" in opts else "type"
        kind = str(opts.pop(key)).lower()

    canon = _match_kind(kind)
    pop = opts.pop
    cfg: Dict[str, Any] = {"type": canon}

    if canon == "rrdb_net":
        lite = kind == "esrgan-lite"
        cfg.update(
            norm_type=pop("norm_type", None),
            mode=pop("mode", "CNA"),
            nf=pop("nf", 32 if lite else 64),
            nb=pop("nb", 12 if lite else 23),
            nr=pop("nr", 3),
            in_nc=pop("in_nc", 3),
            out_nc=pop("out_nc", 3),
            gc=pop("gc", 32),
            convtype=pop("convtype", "Conv3D" if kind == "evsrgan" else "Conv2D"),
            act_type=pop("net_act", None) or pop("act_type", "leakyrelu"),
            gaussian_noise=pop("gaussian", True),
            plus=pop("plus", False),
            finalact=pop("finalact", None),
            upscale=pop("scale", scale),
            upsample_mode=pop("upsample_mode", "upconv"),
        )
    elif canon == "mrrdb_net":
        cfg.update(
            in_nc=pop("in_nc", 3),
            out_nc=pop("out_nc", 3),
            nf=pop("nf", 64),
            nb=pop("nb", 24),
            gc=pop("gc", 32),
        )
    elif canon == "sr_resnet":
        cfg.update(
            in_nc=pop("in_nc", 3),
            out_nc=pop("out_nc", 3),
            nf=pop("nf", 64),
            nb=pop("nb", 16),
            upscale=pop("scale", scale),
            norm_type=pop("norm_type", None),
            act_type=pop("net_act", None) or pop("act_type", "relu"),
            mode=pop("mode", "CNA"),
            upsample_mode=pop("upsample_mode", "pixelshuffle"),
            convtype=pop("convtype", "Conv2D"),
            finalact=pop("finalact", None),
            res_scale=pop("res_scale", 1),
        )
    elif canon == "ppon":
        cfg.update(
            in_nc=pop("in_nc", 3),
            out_nc=pop("out_nc", 3),
            nf=pop("nf", 64),
            nb=pop("nb", 24),
            upscale=pop("scale", scale),
            act_type=pop("net_act", None) or pop("act_type", "leakyrelu"),
            alpha=pop("alpha", 1),
        )
    elif canon == "swinir":
        # the released real-world x4 model M (main_test_swinir.py --task real_sr)
        cfg.update(
            upscale=pop("upscale", scale if scale > 1 else 4),
            in_chans=pop("in_chans", 3),
            img_size=pop("img_size", 64),
            window_size=pop("window_size", 8),
            img_range=pop("img_range", 1.0),
            depths=list(pop("depths", [6] * 6)),
            embed_dim=pop("embed_dim", 180),
            num_heads=list(pop("num_heads", [6] * 6)),
            mlp_ratio=pop("mlp_ratio", 2.0),
            upsampler=pop("upsampler", "nearest+conv"),
            resi_connection=pop("resi_connection", "1conv"),
        )
    elif canon == "hat":
        # the released real-world x4 GAN model (options/test/HAT_GAN_Real_SRx4.yml)
        cfg.update(
            upscale=pop("upscale", scale if scale > 1 else 4),
            in_chans=pop("in_chans", 3),
            img_size=pop("img_size", 64),
            window_size=pop("window_size", 16),
            compress_ratio=pop("compress_ratio", 3),
            squeeze_factor=pop("squeeze_factor", 30),
            conv_scale=pop("conv_scale", 0.01),
            overlap_ratio=pop("overlap_ratio", 0.5),
            img_range=pop("img_range", 1.0),
            depths=list(pop("depths", [6] * 6)),
            embed_dim=pop("embed_dim", 180),
            num_heads=list(pop("num_heads", [6] * 6)),
            mlp_ratio=pop("mlp_ratio", 2.0),
            upsampler=pop("upsampler", "pixelshuffle"),
            resi_connection=pop("resi_connection", "1conv"),
        )
    elif canon == "pan_net":
        cfg.update(
            in_nc=pop("in_nc", 3),
            out_nc=pop("out_nc", 3),
            nf=pop("nf", 40),
            unf=pop("unf", 24),
            nb=pop("nb", 16),
            scale=pop("scale", scale),
            self_attention=pop("self_attention", True),
            double_scpa=pop("double_scpa", False),
            ups_inter_mode=pop("ups_inter_mode", "nearest"),
        )
    elif canon == "wbcunet_net":
        cfg.update(nf=pop("nf", 32))
        cfg["mode"] = "tf" if "tf" in kind else pop("mode", "pt")
    elif canon == "unet_net":
        cfg.update(
            input_nc=pop("in_nc", 3),
            output_nc=pop("out_nc", 3),
            num_downs=pop("num_downs", 7 if kind in ("unet_128", "p2p_128") else 8),
            ngf=pop("ngf", 64),
            norm_type=pop("norm_type", "batch"),
            use_dropout=pop("use_dropout", False),
            upsample_mode=pop("upsample_mode", "deconv"),
        )
    elif canon == "resnet_net":
        if kind in ("resnet_6blocks", "resnet_6", "cg_6"):
            default_blocks = 6
        else:  # resnet_9blocks/resnet_9/cg9 and any other alias
            default_blocks = 9
        cfg.update(
            input_nc=pop("in_nc", 3),
            output_nc=pop("out_nc", 3),
            n_blocks=pop("n_blocks", default_blocks),
            ngf=pop("ngf", 64),
            norm_type=pop("norm_type", "instance"),
            use_dropout=pop("use_dropout", False),
            upsample_mode=pop("upsample_mode", "deconv"),
            padding_type=pop("padding_type", "reflect"),
        )

    # the extension key the model factories read from cfg
    if "outm" in opts:
        cfg["outm"] = opts.pop("outm")
    return cfg
