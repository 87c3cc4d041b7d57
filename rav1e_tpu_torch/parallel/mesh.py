"""The shards a tile-column encode is spread over.

Counterpart of rav1e_tpu/parallel/mesh.py (a 1-D `jax.sharding.Mesh` over
the `sb` axis).  On a GPU the tile columns of a frame are a batch axis of
one device, so a mesh here only names its `n` shards and the torch device
that holds each; every shard lies on the one device it is given.
Spreading shards over several GPUs is ROADMAP queue 2 item 16b.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """`devices[i]` holds shard i."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n: int, device="cuda") -> Mesh:
    """n shards, all on `device`."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh((torch.device(device),) * n)
