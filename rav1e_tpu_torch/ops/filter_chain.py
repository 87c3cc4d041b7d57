"""In-loop filter chain on the GPU: the resident-recon splice, deblock, the
CDEF strength search and apply, and the fused Wiener loop restoration.

Counterpart of rav1e_tpu/ops/filter_chain_jax.py (launch_filter_chain,
collect_filter_chain and _make_kernel.run).  The pre-filter recon of the
device superblocks stays on the card from the wavefront pass; only the
host-coded edge stripes (bottom rows below the last full SB row, right
columns beyond the last full SB column), the per-mi deblock maps and the
source planes are uploaded.  Then, all on the card and without a host
sync:

1. each plane is deblocked by K4, vertical edges then horizontal;
2. with CDEF damping > 0, ops/cdef.search_apply (K5, K6) picks and applies
   the strengths, per superblock when loop restoration is on (sb_lam =
   the frame's lambda: the per-SB cdef_idx is interleaved by the deferred
   entropy pass) and one pair for the frame otherwise (sb_lam = inf);
3. with loop restoration on (and neither the SGR search nor lossless),
   ops/lrf solves the frame's Wiener taps (K7) and restores each plane
   with its none-vs-Wiener choice per unit (K8).

collect_filter_chain copies the planes back into fe.rec and fills the
CDEF strengths and the fused LR decision for the host entropy pass.  With
the SGR search (speed <= 5, where the chain runs only when the deblock
levels are all zero) the chain skips the fused LR and hands back the
deblocked planes, on the host for the per-unit search and on the device
for its trial filter (filter_chain_jax.py:327, :360).  With the fused LR
stage switched off (RAV1E_TPU_LR_FUSE=0, as in the JAX package) and no
SGR search, the chain keeps the deblocked and CDEF planes and the source
planes on the device only, for ops/lrf.lr_decide_device (filter_chain_jax
.py:431-434, :456-458).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rav1e_tpu_torch.ops import cdef
from rav1e_tpu_torch.ops import deblock as db
from rav1e_tpu_torch.ops import lrf


def _splice(fe, dev_rec, device):
    """The pre-filter planes (coded size) on the device: the wavefront's
    resident recon with the host-coded edge stripes spliced in, or the
    whole host recon when there is no resident copy."""
    h, w = fe.coded_h, fe.coded_w
    ch, cw = h >> 1, w >> 1
    up = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=device)
    if dev_rec is None:
        return [up(fe.rec[0][:h, :w]), up(fe.rec[1][:ch, :cw]),
                up(fe.rec[2][:ch, :cw])]
    planes = [dev_rec[0][:h, :w].to(torch.int32),
              dev_rec[1][:ch, :cw].to(torch.int32),
              dev_rec[2][:ch, :cw].to(torch.int32)]
    dev_h, dev_w = (h // 64) * 64, (w // 64) * 64
    for p in range(3):
        s = 0 if p == 0 else 1
        ph, pw = (h, w) if p == 0 else (ch, cw)
        yh, xw = dev_h >> s, dev_w >> s
        if yh < ph:
            planes[p][yh:ph, :] = up(fe.rec[p][yh:ph, :pw])
        if xw < pw:
            planes[p][:yh, xw:pw] = up(fe.rec[p][:yh, xw:pw])
    return planes


def _lr_fuse(fe):
    """(out_w, out_h) when the fused LR stage runs (filter_chain_jax.py
    :359-363), else None.  RAV1E_TPU_LR_FUSE=0 switches it off: the taps
    are then solved on the host and the decision is lr_decide_device."""
    if (fe.lrf and not getattr(fe, "sgr_search", False) and fe.q > 0
            and os.environ.get("RAV1E_TPU_LR_FUSE", "1") != "0"):
        return fe.out_w, fe.out_h
    return None


def _restore(planes, dbs, srcs, fe, out_w: int, out_h: int):
    """The fused LR stage: taps (K7), then each plane's restoration, unit
    choice and composition (K8).  Returns (composed planes, choices,
    taps (6, 3), en (3,)) on the device."""
    cwo, cho = (out_w + 1) >> 1, (out_h + 1) >> 1
    dims = ((out_h, out_w, 64, lrf.LR_RATE_Y), (cho, cwo, 32, lrf.LR_RATE_C),
            (cho, cwo, 32, lrf.LR_RATE_C))
    taps, en = lrf.wiener_solve(
        [p[:hh, :ww] for p, (hh, ww, _u, _r) in zip(planes, dims)],
        [s[:hh, :ww] for s, (hh, ww, _u, _r) in zip(srcs, dims)])
    comp, choice = [], []
    for p, (hh, ww, unit, rate) in enumerate(dims):
        c, t = lrf.wiener_lr(planes[p], dbs[p], srcs[p],
                             taps[2 * p : 2 * p + 2], en[p : p + 1],
                             float(np.float32(fe.lam)), rate, unit, hh, ww)
        comp.append(c)
        choice.append(t)
    return comp, choice, taps, en


def filter_chain_device(fe) -> bool:
    """Launch and collect in one call (filter_chain_jax.py:299): False when
    the frame is outside the chain's envelope, else True with fe.rec
    filtered."""
    handle = launch_filter_chain(fe)
    if handle is None:
        return False
    return collect_filter_chain(fe, handle)


def launch_filter_chain(fe):
    """Enqueue the in-loop filters of an IntraFrameEncoder's recon on its
    device.  Returns a handle for collect_filter_chain, or None when the
    frame is outside the device chain's envelope (8-bit 4:2:0)."""
    if fe.bd != 8 or not fe._is420:
        return None
    device = fe.device
    h, w = fe.coded_h, fe.coded_w
    ch, cw = h >> 1, w >> 1
    dev_rec = getattr(fe, "_wf_dev_out", None)
    planes = _splice(fe, dev_rec, device)
    info = fe.db_info
    maps = [torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in (info.txw, info.txh, info.bx, info.by)]
    skip = torch.as_tensor(np.ascontiguousarray(info.skip), device=device)
    dbs = []
    for p in range(3):
        s = 0 if p == 0 else 1
        dbs.append(db.deblock_plane(
            planes[p], *maps, skip, p, s, s,
            *db.plane_lims(fe.lf_levels, fe.lf_sharpness, p, fe.bd),
            fe.bd).contiguous())
    lr_fuse = _lr_fuse(fe)
    # LR without the fused stage reads the deblocked planes: the host LR
    # search (SGR, per-unit taps) on the host, lr_decide_device on the
    # device, with the sources
    sgr = fe.lrf and getattr(fe, "sgr_search", False)
    keep_db = dbs if fe.lrf and lr_fuse is None else None
    keep_src = keep_db is not None and not sgr
    if not fe.cdef_damping and lr_fuse is None and not keep_src:
        return {"planes": dbs, "cdef": None, "lr": None, "db": keep_db,
                "src": None}
    srcs = [torch.as_tensor(np.ascontiguousarray(fe.src[p][:hh, :ww],
                                                 np.int32), device=device)
            for p, (hh, ww) in enumerate(((h, w), (ch, cw), (ch, cw)))]
    out, sel = dbs, None
    if fe.cdef_damping:
        # per-SB strengths need the deferred entropy pass (pass B) to
        # interleave cdef_idx literals; only the LR two-pass flow has it
        sb_lam = np.float32(fe.lam if fe.lrf else np.inf)
        use_sb, frame_best, idx_map, *out = cdef.search_apply(
            *dbs, *srcs, skip, float(sb_lam), fe.cdef_damping, fe.bd)
        sel = (use_sb, frame_best, idx_map)
    lr = _restore(out, dbs, srcs, fe, *lr_fuse) if lr_fuse else None
    return {"planes": out, "cdef": sel, "lr": lr, "db": keep_db,
            "src": srcs if keep_src else None}


def collect_filter_chain(fe, handle) -> bool:
    """Wait on a launch_filter_chain handle: copy the filtered planes back
    into fe.rec and fill the CDEF strengths (fe.cdef_strengths,
    fe.cdef_sb) and the fused LR decision (fe._chain_lr = (composed
    planes, choices, taps, en)), or for LR without the fused stage the
    deblocked planes (fe._dev_db, fe._dev_cdef and their chroma pairs
    fe._dev_db_c, fe._dev_cdef_c on the device; for the host LR search
    also fe._deblock_copy on the host, else None and the source planes
    fe._dev_src on the device)."""
    h, w = fe.coded_h, fe.coded_w
    ch, cw = h >> 1, w >> 1
    with fe.stats.stage("chain_wait"):
        y, u, v = (p.cpu().numpy() for p in handle["planes"])
        sel = handle["cdef"]
        if sel is not None:
            use_sb, frame_best, idx_map = (t.cpu().numpy() for t in sel)
        lr = handle["lr"]
        if lr is not None:
            comp, choice, taps, en = lr
            comp = [c.cpu().numpy() for c in comp]
            choice = {p: c.cpu().numpy() for p, c in enumerate(choice)}
            taps, en = taps.cpu().numpy(), en.cpu().numpy() != 0
    fe.rec[0][:h, :w] = y
    fe.rec[1][:ch, :cw] = u
    fe.rec[2][:ch, :cw] = v
    if sel is not None:
        fe.cdef_strengths, fe.cdef_sb = cdef._sb_result(
            bool(use_sb), int(frame_best), idx_map.astype(np.int32))
    else:
        fe.cdef_strengths = None
        fe.cdef_sb = None
    fe._chain_lr = (comp, choice, taps, en) if lr is not None else None
    db = handle["db"]
    if db is not None:
        copies = None
        if handle["src"] is None:  # the host LR search's planes
            copies = []
            for p, d in enumerate(db):
                full = np.array(fe.rec[p])
                full[: d.shape[0], : d.shape[1]] = d.cpu().numpy()
                copies.append(full)
        fe._deblock_copy = copies
        fe._dev_src = handle["src"]
        planes = handle["planes"]
        fe._dev_db, fe._dev_cdef = db[0], planes[0]
        fe._dev_db_c, fe._dev_cdef_c = tuple(db[1:]), tuple(planes[1:])
    return True
