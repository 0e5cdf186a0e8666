"""Image-level data parallelism across processes: the work list is striped.

The port's counterpart of ``innfer_tpu/parallel/multihost.py``, which is
``shard_paths`` only.  Each process takes every ``num_shards``-th image of
the sorted list from ``shard_index`` on, so no coordinator is needed and a
failed shard is re-run by its index alone.  The JAX package's
``init_distributed`` (``jax.distributed``) is not carried: the port's
defaults are shard 0 of 1, and the CLI takes ``--shard-index`` and
``--num-shards`` explicitly.
"""
from __future__ import annotations

from typing import List


def shard_paths(paths: List[str], shard_index: int, num_shards: int) -> List[str]:
    """Deterministic striped split of the (sorted) work list."""
    if num_shards <= 1:
        return list(paths)
    if not (0 <= shard_index < num_shards):
        raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
    return [p for i, p in enumerate(paths) if i % num_shards == shard_index]
