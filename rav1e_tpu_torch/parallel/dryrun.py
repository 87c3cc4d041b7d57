"""The multi-device dry run: a tile encode, the sharded deblock and the
public API over a mesh of several slots, each against its single-device
result.

Counterpart of __graft_entry__.py:77 dryrun_multichip, with its three
checks at its sizes (a 64*n x 128 frame, quantizer 120):

1. an IntraFrameEncoder with n tile columns writes the same bytes and
   recon through the tile route over the n slots as on one device;
2. deblock_sharded over the n slots equals deblock_np.deblock_plane (on
   a plane of flat 32x32 blocks with a little noise, where the edges
   filter: on dryrun_multichip's uniform noise no edge passes the filter
   masks);
3. Config(threads=n) with tile_cols=n writes the bytes of threads=0 over
   a key frame and two inter frames (the Context picks its own slots,
   parallel/mesh.py slots_for).

    python -m rav1e_tpu_torch.parallel.dryrun [N] [--cpu]

runs it on N slots: the visible GPUs (N slots on cuda:0 where there is
one), or with --cpu N slots on the CPU.  It prints one JSON line.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


def _tiny_encoder(w, h, q, tiles_log2, device):
    """__graft_entry__.py:6 _tiny_encoder on `device`: (encoder, planes)."""
    from rav1e_tpu_torch.models.intra_frame import IntraFrameEncoder

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip((xx + 2 * yy) % 256 + rng.integers(-10, 10, (h, w)),
                0, 255).astype(np.int32)
    u = ((xx[::2, ::2] + 60) % 220).astype(np.int32)
    v = ((yy[::2, ::2] + 90) % 230).astype(np.int32)
    fe = IntraFrameEncoder(w, h, q_idx=q, device_modes=True,
                           tile_cols_log2=tiles_log2, device=device)
    return fe, [y, u, v]


def default_slots(n: int) -> list:
    """The visible GPUs (at most n), or n slots on cuda:0 where there is
    one; a raise where there is none."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("dryrun_multidevice: no CUDA device; pass "
                           "devices=['cpu'] * n to run on the CPU")
    if count == 1:
        return ["cuda:0"] * n
    return [f"cuda:{i}" for i in range(min(n, count))]


def _public_api(w, h, n, threads, device):
    """__graft_entry__.py:146-181: a key + 2 inter GOP through Config with
    n tile columns and `threads`.  Returns (bytes, Context)."""
    from rav1e_tpu_torch.api.config import Config, EncoderConfig
    from rav1e_tpu_torch.api.context import EncoderError, EncoderStatus
    from rav1e_tpu_torch.utils.frame import Frame

    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (h + 8, w + 8), np.uint8)
    frames = []
    for t in range(3):
        y = base[t : t + h, 2 * t : 2 * t + w]
        frames.append(Frame.from_planes(
            y, y[::2, ::2] // 2 + 30, y[::2, ::2] // 3 + 50))
    cfg = Config(enc=EncoderConfig(width=w, height=h, quantizer=120,
                                   tile_cols=n, max_key_frame_interval=16,
                                   low_latency=True),
                 threads=threads, device=device)
    ctx = cfg.new_context()
    out = []

    def drain():
        while True:
            try:
                out.append(ctx.receive_packet().data)
            except EncoderError as e:
                if e.status in (EncoderStatus.NEED_MORE_DATA,
                                EncoderStatus.LIMIT_REACHED):
                    return
                raise

    for f in frames:
        ctx.send_frame(f)
        drain()
    ctx.flush()
    drain()
    return b"".join(out), ctx


def dryrun_multidevice(n: int, devices=None) -> dict:
    """The three checks on n slots (`devices`, default default_slots(n)).
    Raises on any difference; returns (and prints) the JSON line."""
    from rav1e_tpu_torch.ops.deblock_np import DeblockInfo, deblock_plane
    from rav1e_tpu_torch.parallel.mesh import make_mesh
    from rav1e_tpu_torch.parallel.tiles import deblock_sharded

    slots = list(devices) if devices is not None else default_slots(n)
    mesh = make_mesh(n, devices=slots)
    dev0 = str(mesh.slots[0])
    w, h = 64 * n, 128
    tiles_log2 = max(1, (n - 1).bit_length())

    fe_a, planes = _tiny_encoder(w, h, 120, tiles_log2, dev0)
    tile_a, recon_a = fe_a.encode([p.copy() for p in planes])
    fe_b, _ = _tiny_encoder(w, h, 120, tiles_log2, dev0)
    fe_b.wavefront_mesh = mesh
    tile_b, recon_b = fe_b.encode([p.copy() for p in planes])
    if fe_b.stats.key_routes != {"tiles": 1}:
        raise RuntimeError(f"the mesh encode took {fe_b.stats.key_routes}")
    if tile_a != tile_b or not all(np.array_equal(recon_a[p], recon_b[p])
                                   for p in range(3)):
        raise RuntimeError("the tile encode over the slots diverged from "
                           "the single-device encode")

    # the sharded deblock against the serial oracle
    rng = np.random.default_rng(1)
    info = DeblockInfo(h // 4, w // 4)
    for y0 in range(0, h, 32):
        for x0 in range(0, w, 32):
            info.set_block(x0, y0, 32, 32, bool(rng.integers(0, 2)))
    flat = np.kron(rng.integers(60, 200, (h // 32, w // 32)),
                   np.ones((32, 32), np.int64))
    plane = (flat + rng.integers(-1, 2, (h, w))).astype(np.int32)
    ref = plane.copy()
    deblock_plane(ref, info, 0, (24, 30, 18, 20), 2, 0, 0, 8, w, h)
    out = deblock_sharded(mesh, plane, info, (24, 30, 18, 20), 2, 0, 0, 0,
                          8, w, h)
    if not np.array_equal(out, ref) or np.array_equal(ref, plane):
        raise RuntimeError("the sharded deblock diverged from deblock_np "
                           "(or filtered nothing)")

    # the public API: the Context's own mesh against threads=0
    api_dev = "cuda" if devices is None else dev0
    t0 = time.perf_counter()
    solo, _ = _public_api(w, h, n, 0, api_dev)
    t_solo = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded, ctx = _public_api(w, h, n, n, api_dev)
    t_shard = time.perf_counter() - t0
    ctx_mesh = getattr(ctx._encoder, "wavefront_mesh", None)
    if ctx_mesh is None:
        raise RuntimeError("the public config did not construct the mesh")
    if solo != sharded:
        raise RuntimeError("the public-API sharded encode diverged")
    gpus = {d for d in mesh.slots if d.type == "cuda"}
    line = {"multichip_public_api": "byte-identical", "devices": n,
            "slots": [str(d) for d in mesh.slots],
            "context_slots": [str(d) for d in ctx_mesh.slots],
            "distinct_gpus": len(gpus),
            "t_1dev_s": t_solo, "t_sharded_s": t_shard,
            "scaling_efficiency": t_solo / t_shard}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n_ = int(args[0]) if args else 4
    dryrun_multidevice(n_, ["cpu"] * n_ if "--cpu" in sys.argv else None)
