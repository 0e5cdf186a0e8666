"""The port's hand-written kernels.  Each ops module that a model runs a
kernel from (``rdb``, ``resnet_block``, ``tail_conv``, ``dilated_block``,
``instance_norm``, ``window_attn``, ``layer_norm``, ``token_gemm``,
``hat_attn``) has a
``fusable`` predicate, and the model takes the kernel exactly where it
holds and the plain composition elsewhere."""
from __future__ import annotations

import contextlib
from typing import Iterator


@contextlib.contextmanager
def plain_path() -> Iterator[None]:
    """Every model runs its plain composition inside: the nine ``fusable``
    predicates answer False.  For tests and scripts that hold a kernel
    against its plain version on the card; the package never enters it.
    The predicates are read when a model runs, so run the model inside."""
    from innfer_tpu_torch.ops import (dilated_block, hat_attn, instance_norm, layer_norm, rdb,
                                      resnet_block, tail_conv, token_gemm, window_attn)

    modules = (rdb, resnet_block, tail_conv, dilated_block, instance_norm, window_attn,
               layer_norm, token_gemm, hat_attn)
    saved = [m.fusable for m in modules]
    for m in modules:
        m.fusable = lambda *a, **k: False
    try:
        yield
    finally:
        for m, f in zip(modules, saved):
            m.fusable = f
