"""The shards a tile-column encode or a sharded deblock is spread over.

Counterpart of rav1e_tpu/parallel/mesh.py (a 1-D `jax.sharding.Mesh` over
the `sb` axis).  A mesh here is `n` shards laid contiguously over an
ordered list of device slots: slot j holds shards [n*j // S, n*(j+1) // S)
of S slots.  With one slot, the tile columns of a frame are a batch axis
of that device's one pass.  Slots on several GPUs spread the work over
them from this one process, as the JAX mesh is driven by one controller:
a slot's tensors live on its device and the exchange between shards is a
copy from one device to the other (over NVLink where the GPUs have it).
Slots may repeat a device, so several slots can share the CPU or one
GPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """`n` shards over the devices of `slots`, in order."""

    n: int
    slots: tuple

    @property
    def size(self) -> int:
        return self.n

    @property
    def devices(self) -> tuple:
        """The device of each shard: its slot's."""
        return tuple(self.slots[i * len(self.slots) // self.n]
                     for i in range(self.n))

    def groups(self, count: int) -> list:
        """`count` items (tile columns) laid over the slots as the shards
        are: (device, range of items) for each slot that holds any."""
        S = len(self.slots)
        out = []
        for j, dev in enumerate(self.slots):
            r = range(count * j // S, count * (j + 1) // S)
            if len(r):
                out.append((dev, r))
        return out


def _present(dev: torch.device) -> torch.device:
    """`dev`, or a raise when this process cannot reach it: a slot never
    moves to another device."""
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"a mesh slot is the CPU or a CUDA device, not {dev}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if (dev.index or 0) >= count:
        raise RuntimeError(f"mesh slot {dev}: this process sees {count} "
                           "CUDA device(s)")
    return dev


def make_mesh(n: int, devices=("cuda",)) -> Mesh:
    """n shards over one slot per entry of `devices` (entries may repeat;
    at most n of them); a single device is one slot."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    if isinstance(devices, (str, torch.device)):
        devices = (devices,)
    slots = tuple(torch.device(d) for d in devices)
    if len(slots) > n:
        raise ValueError(f"{len(slots)} slots for {n} shards")
    return Mesh(n, tuple(_present(d) for d in slots))


def slots_for(device, n: int, device_count: int) -> list:
    """The slots of a Context's mesh of n shards on `device` with
    `device_count` GPUs visible: the first min(n, device_count) GPUs when
    the device is an unindexed "cuda" and more than one is visible (the
    JAX Context lays its shards over min(threads, tile_cols,
    len(jax.devices())) devices, rav1e_tpu/api/context.py:228-231), else
    one slot on the device."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None and device_count > 1:
        return [torch.device("cuda", i) for i in range(min(n, device_count))]
    return [d]
