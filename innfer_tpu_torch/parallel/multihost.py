"""Image-level data parallelism across processes: the work list is striped.

The port's counterpart of ``innfer_tpu/parallel/multihost.py``.  The unit
of work is one image: each process takes every ``num_shards``-th image of
the sorted list from ``shard_index`` on, so no communication is needed in
the hot loop and a failed shard is re-run by its index alone.

``init_distributed`` is the JAX package's ``jax.distributed`` step on
``torch.distributed``: it joins the processes (``--coordinator``,
``--num-processes``, ``--process-id``) only to learn each one's rank and
the world size, which the CLI takes as its shard index and count.  It
uses the gloo backend over TCP: no collective runs on a card, and NCCL
refuses two ranks on one GPU, which a one-card machine runs.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch.distributed as dist


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Join the process group when ``num_processes > 1`` (gloo, TCP
    rendezvous at ``coordinator``, "host:port"); returns (rank, world):
    the initialised group's, else (0, 1)."""
    if num_processes is not None and num_processes > 1:
        dist.init_process_group(
            "gloo", init_method=None if coordinator is None else f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id)
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def shard_paths(paths: List[str], shard_index: int, num_shards: int) -> List[str]:
    """Deterministic striped split of the (sorted) work list."""
    if num_shards <= 1:
        return list(paths)
    if not (0 <= shard_index < num_shards):
        raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
    return [p for i, p in enumerate(paths) if i % num_shards == shard_index]
