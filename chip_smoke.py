#!/usr/bin/env python3
"""Smoke run of rav1e_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the ten CUDA kernels (csrc/*.cu, one nvcc each, in parallel)
   and the native entropy library, and prints the build seconds.
3. Drives the main path once: 8 key frames of 1920x1080 through Config ->
   Context in bench.py's keyframe configuration (speed-6 defaults, so
   CDEF and loop restoration on; quantizer 100, low latency).  Every
   kernel's launch count is set to 0 just before and read just after;
   each of the eight must have launched.
4. Holds each kernel against its plain PyTorch version on the card, on the
   inputs the main path gave it (the largest call of each):
   intra_pred, inv_txfm, deblock, cdef_dir, cdef_filter (search and
   apply) and wiener_lr (also with every unit forced to take Wiener)
   must be identical; wiener_solve's taps identical
   or 1 apart where the exact coef * 128 lies within 1e-9 of a .5 tie;
   fwd_txq's levels and dequantised values identical except where the
   exact coefficient lies within the fp32 error bound of a .5 rounding
   tie, and such coefficients may be at most FDCT_TIE_SHARE of them.
   Times each (CUDA events, warmed) beside its plain version, its bound
   and, for fwd_txq, the torch.matmul forward transform.
5. Checks the output: with libdav1d present the stream decodes to the
   encoder's recon; in every case 16 sampled superblocks a frame re-derive
   from their records with the numpy oracles onto the pre-filter recon,
   and on FILTER_FRAMES frames deblock_np, cdef_np with each superblock's
   strengths and lrf_np's Wiener filter on the chosen units, over the
   pre-filter frame, give the output recon exactly.
6. Drives the keyframe path with CDEF and loop restoration off on 2
   frames, with the counts set to 0 before it: K1-K4 must launch, and its
   output is checked the same way.
7. Times a second encode of the first KEY_TIMED frames of the main path
   (frames/s), then an encode of the first four with each device stage
   timed serialised (wavefront pass, band maps, the filter chain and,
   inside it, CDEF and LR); with --profile also under torch.profiler (the
   card's busy time by kernel; minutes).  Times the CDEF decision glue
   (ops/cdef.py decide) alone beside its bound.
8. Drives the mixed-GOP path: bench.py's mixed configuration (1 key + 15
   inter frames of 1920x1080, max_key_frame_interval 240, low latency,
   speed-6 defaults), with the counts set to 0 before it.  All 15 inter
   frames must take the inter wavefront, every kernel must launch (K9
   mc_pred, K10 me_fullpel and fwd_txq with thinning among them), and
   blocks must choose inter prediction with nonzero MVs.  Holds K9 and
   K10 (identical) and fwd_txq with thinning (the tie rule) against their
   plain versions on the path's largest calls, timed beside their bounds;
   re-derives sampled superblocks of every frame (inter blocks by mc_np
   from the reference's output recon) and INTER_FILTER_FRAMES inter frames
   through deblock_np, cdef_np and lrf_np; a second encode must write the
   same bytes, and gives the mixed GOP's frames/s and stage seconds.

The line before the last is the card's name and power limit; the last is
{"ok": true, "device": {...}}.  Any failed phase exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

W, H, NFRAMES = 1920, 1080, 8
MIXED_FRAMES = 16  # bench.py's mixed GOP: 1 key + 15 inter
KEY_TIMED = 4  # frames of the keyframe path's timed second encode
SB_SAMPLES = 16
FILTER_FRAMES = 2  # frames whose whole filter chain is re-derived in numpy
INTER_FILTER_FRAMES = 2  # inter frames of the mixed GOP re-derived so
OFF_FRAMES = 2  # frames of the CDEF/LR-off path
WIENER_TIE = 1e-9  # |coef * 128 - (k + .5)| where a tap may round apart
FDCT_TIE_SHARE = 1e-3
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_FP32 = 67e12  # H100 SXM fp32 outside the tensor cores, FLOP/s


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def encode(frames, check: bool, device: str = "cuda", filters: bool = True,
           mixed: bool = False):
    """Encode `frames` through the public API on `device`, in bench.py's
    keyframe configuration (filters=False: with CDEF and loop restoration
    off), or with mixed in its mixed-GOP configuration (a key frame, then
    inter frames).  With check, keep each frame's pre-filter planes and
    wavefront records; the encoders are returned in coding order."""
    from rav1e_tpu_torch import Config, EncoderConfig, SpeedSettings
    from rav1e_tpu_torch.api.context import EncoderError, EncoderStatus
    from rav1e_tpu_torch.models import inter_frame, intra_frame
    from rav1e_tpu_torch.ops import filter_chain

    ss = SpeedSettings.from_preset(6)
    if not filters:
        ss.cdef = False
        ss.lrf = False
    if mixed:
        enc = EncoderConfig(width=W, height=H, quantizer=100,
                            max_key_frame_interval=240,
                            rdo_lookahead_frames=8, low_latency=True,
                            speed_settings=ss)
    else:
        enc = EncoderConfig(
            width=W, height=H, quantizer=100, min_key_frame_interval=1,
            max_key_frame_interval=1, rdo_lookahead_frames=8,
            low_latency=True, speed_settings=ss)
    cfg = Config(enc=enc, device=device)
    seen = []
    orig_splice = filter_chain._splice
    orig_tiles = intra_frame.IntraFrameEncoder._encode_tiles_wavefront
    orig_install = inter_frame.InterFrameEncoder._install_wavefront

    def splice(fe, dev_rec, device):
        planes = orig_splice(fe, dev_rec, device)
        fe._chk_prefilter = [p.cpu().numpy() for p in planes]
        return planes

    def tiles(self, wf):
        self._chk_wf = wf
        seen.append(self)
        return orig_tiles(self, wf)

    def install(self, wf):
        self._chk_wf = wf
        seen.append(self)
        return orig_install(self, wf)

    if check:
        filter_chain._splice = splice
        intra_frame.IntraFrameEncoder._encode_tiles_wavefront = tiles
        inter_frame.InterFrameEncoder._install_wavefront = install
    try:
        ctx = cfg.new_context()
        pkts = []

        def drain():
            while True:
                try:
                    pkts.append(ctx.receive_packet())
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
    finally:
        filter_chain._splice = orig_splice
        intra_frame.IntraFrameEncoder._encode_tiles_wavefront = orig_tiles
        inter_frame.InterFrameEncoder._install_wavefront = orig_install
    if len(pkts) != len(frames):
        raise RuntimeError(f"{len(pkts)} packets for {len(frames)} frames")
    recon = [ctx._encoder.recon_by_input[i] for i in range(len(frames))]
    encode.stages = dict(ctx._encoder.stats.stage_seconds)
    encode.mode_counts = dict(ctx._encoder.stats.mode_counts)
    encode.frame_types = [p.frame_type for p in pkts]
    return [p.data for p in pkts], recon, seen


def _fwd_work(a, k, levels: bool):
    resid, Fv = a[0], a[1]
    n, m = resid.shape[-1], Fv.shape[-2]
    nb = resid.numel() // (n * n)
    return (resid.numel() * 4 + Fv.numel() * 8
            + nb * ((m * m * 8 if levels else 0) + 12),
            nb * 2 * m * n * (n + m))


# Integer operations, counted from the work each function needs.  The
# card's published table has no integer rate: they are divided by the
# fp32 rate (PEAK_FP32), the most 32-bit scalar operations the SMs run a
# second (the integer ALUs run at most as many), so the bound stays a
# lower bound on the time.
CDEF_TAP_OPS = 12  # one tap: difference, constrain (abs, shift, subtract,
#                    two clamps, sign), weight and sum, valid-tap min, max
CDEF_OUT_OPS = 7   # a filtered sample: rounding of the sum, offset, clip
SSE_OPS = 3        # subtract, square, accumulate
WIENER_PASS_OPS = 17  # one 7-tap pass: 7 multiplies, 6 adds, round, clip


def _cdef_filter_work(a, k):
    """Bytes and operations of one K6 launch.  Bytes: search reads six
    int32 planes and writes 11 sums a superblock, apply reads three planes
    and writes three; both read the block maps (int32 dirs and var, u8
    active).  Operations: the taps each candidate runs on this frame's
    blocks (4 primary taps where the block is active and its adjusted
    primary strength nonzero, 8 secondary taps where its secondary
    strength is nonzero, CDEF_OUT_OPS for a filtered sample), and in the
    search each sample's SSE for every candidate."""
    import torch

    from rav1e_tpu_torch.ops import cdef

    h, w = a[0].shape
    ny, nc = a[0].numel(), 2 * a[1].numel()
    dirs, var, act = a[6], a[7], a[8].to(torch.bool)
    nb, nsb = dirs.numel(), -(-h // 64) * -(-w // 64)

    def ops(pri, sec, samples):  # per-block strengths, samples a block
        pos = lambda t: torch.as_tensor(t, device=act.device) > 0
        taps = (4 * pos(pri) + 8 * pos(sec)) * act
        return int(((taps * CDEF_TAP_OPS + (taps > 0) * CDEF_OUT_OPS)
                    * samples).sum())

    if a[10] == cdef.SEARCH:
        n = sum(ops(cdef._adjust(p, var), s, 64) for p, s in cdef.Y_CANDIDATES)
        n += sum(ops(p, 0, 32) for p, _ in cdef.UV_CANDIDATES)
        n += (ny * len(cdef.Y_CANDIDATES) + nc * len(cdef.UV_CANDIDATES)) \
            * SSE_OPS
        return (ny + nc) * 8 + nsb * 44 + nb * 9, n
    nby, nbx = dirs.shape
    idx_b = a[11].long().repeat_interleave(8, 0) \
        .repeat_interleave(8, 1)[:nby, :nbx]
    ypri, ysec, _, uvpri, _ = cdef._cand_maps(dirs, var, idx_b)
    return ((ny + nc) * 8 + nsb * 4 + nb * 9,
            ops(ypri, ysec, 64) + ops(uvpri, 0, 32))


def _wiener_lr_work(a, k):
    """Bytes and operations of one K8 launch: the CDEF output and the
    source read once, the deblocked plane only in the rows the stripe rule
    takes from it, the composed plane written once (int32); the horizontal
    pass over each distinct source row (the plane's and those deblocked
    rows), the vertical pass, the two SSE and the choice over each
    sample."""
    import numpy as np

    from rav1e_tpu_torch.ops import lrf, lrf_np

    unit, hh, ww = a[7], a[8], a[9]
    ridx, use_db = lrf.stripe_table(hh, unit)
    db_rows = np.unique(ridx[use_db]).size
    units = lrf_np.count_units(unit, hh) * lrf_np.count_units(unit, ww)
    n = hh * ww
    return (n * 12 + db_rows * ww * 4 + units * 4 + 28,
            (hh + db_rows) * ww * WIENER_PASS_OPS
            + n * (WIENER_PASS_OPS + 2 * SSE_OPS + 1))


MC_PASS_OPS = (18, 20)  # a sample of the horizontal / vertical 8-tap pass:
#                         8 multiplies and 8 adds, then round and shift
#                         (and two clamps after the vertical pass)
SAD_OPS = 3  # subtract, absolute value, accumulate


def _mc_work(a, k):
    """Bytes and operations of one K9 launch: the padded reference plane
    read once (uint8), four int32 words a block in, the int32 prediction
    out; the two passes over each block's samples."""
    ref, n, w, h = a[0], a[2].numel(), a[6], a[7]
    return (ref.numel() * ref.element_size() + n * 16 + n * w * h * 4,
            n * ((h + 7) * w * MC_PASS_OPS[0] + h * w * MC_PASS_OPS[1]))


def _me_work(a, k):
    """Bytes and operations of one K10 call (its two launches): both
    planes read once (uint8), two int32 words a 32x32 block out; the 4x4
    sums of both planes, the 289 quarter-resolution SADs of 64 terms and
    the 25 full-resolution SADs of 1024 terms a block, and both argmins."""
    src, ref = a[0], a[1]
    hh, ww = src.shape
    nb = (hh // 32) * (ww // 32)
    return (src.numel() + ref.numel() + nb * 8,
            2 * (hh * ww // 16) * 15 + nb * (289 * 64 + 25 * 1024) * SAD_OPS
            + nb * (289 + 25) * 2)


def _decide_work(a, k):
    """Bytes and operations of the CDEF decision (ops/cdef.py decide): the
    11 candidates' superblock SSE (int32) and the per-mi skip map read,
    the per-SB index map written; the joint cost, per-SB and frame sums
    and argmins over the 8 pairs, and the skip reduction per mi."""
    sse, skip = a[0], a[1]
    nsb = sse[0].numel()
    return (sse.numel() * 4 + skip.numel() * skip.element_size()
            + nsb * 4 + 16, nsb * 8 * 5 + skip.numel())


# (bytes, operations) of one call of each kernel from its arguments: each
# input read once, each output written once; operations are fp32 FLOPs
# (K2) or integer operations (the rest), counted per sample
WORK = {
    "intra_pred": lambda a, k: (
        a[0].numel() * 8 + a[2].numel() * 2
        + a[0].shape[0] * (61 if a[5] else 7) * a[4] ** 2 * 4,
        a[0].shape[0] * (61 if a[5] else 7) * a[4] ** 2 * 10),
    "fwd_txq": lambda a, k: _fwd_work(a, k, True),
    # K2 with the inter race's thinning: one float threshold a block more
    "fwd_txq_thin": lambda a, k: (
        _fwd_work(a, k, True)[0] + a[0].numel() // a[0].shape[-1] ** 2 * 4,
        _fwd_work(a, k, True)[1]),
    "mc_pred": _mc_work,
    "me_fullpel": _me_work,
    "cdef_decide": _decide_work,
    "fwd_rd_float": lambda a, k: _fwd_work(a, k, False),
    "inv_txfm": lambda a, k: (a[0].numel() * 8,
                              a[0].numel() * 4 * a[0].shape[-1].bit_length()),
    "deblock": lambda a, k: (a[0].numel() * 8 + a[5].numel() * 9,
                             a[0].numel() * 100 / 4),
    # K5: ~14 a sample (bins and weighted squares)
    "cdef_dir": lambda a, k: (a[0].numel() * 4 + a[0].numel() // 64 * 8,
                              a[0].numel() * 14),
    "cdef_filter": _cdef_filter_work,
    # K7: ~30 a sample and direction
    "wiener_solve": lambda a, k: (sum(d.numel() for d in a[0]) * 8 + 84,
                                  sum(d.numel() for d in a[0]) * 2 * 30),
    "wiener_lr": _wiener_lr_work,
}


def bound_ms(nbytes, ops) -> float:
    return max(nbytes / PEAK_BYTES, ops / PEAK_FP32) * 1e3


class Capture:
    """Wraps the kernels' public functions during the main path, keeps the
    inputs of each kernel's largest call (cloned) and sums the bound of
    every call by stage (the wavefront pass, the band maps, the filter
    chain): the least time the card could take for the stage's kernel
    work."""

    def __init__(self):
        from rav1e_tpu_torch.models import device_pipeline
        from rav1e_tpu_torch.ops import (cdef, deblock, filter_chain, intra,
                                         lrf, mc, transforms)

        self.calls = {}
        self.bounds = {}
        self.stage = "wavefront_pass"
        self._undo = []
        for mod, name, stage in (
                (device_pipeline, "launch_band_rd_maps", "band_maps"),
                (filter_chain, "launch_filter_chain", "filter_chain")):
            self._stage(mod, name, stage)
        for mod, name, key, size in (
                (cdef, "cdef_dir", "cdef_dir", lambda a, k: a[0].numel()),
                (cdef, "cdef_filter",
                 lambda a, k: ("cdef_filter_search" if a[10] == cdef.SEARCH
                               else "cdef_filter_apply"),
                 lambda a, k: a[0].numel()),
                (lrf, "wiener_solve", "wiener_solve",
                 lambda a, k: sum(d.numel() for d in a[0])),
                (lrf, "wiener_lr", "wiener_lr", lambda a, k: a[8] * a[9]),
                (intra, "intra_pred", "intra_pred",
                 lambda a, k: a[0].shape[0] * (61 if a[5] else 7) * a[4] ** 2),
                (transforms, "fwd_txq",
                 lambda a, k: ("fwd_txq" if k.get("thr") is None
                               else "fwd_txq_thin"),
                 lambda a, k: a[0].numel()),
                (mc, "mc_block_batch", "mc_pred",
                 lambda a, k: a[2].numel() * a[6] * a[7]),
                (device_pipeline, "me_fullpel", "me_fullpel",
                 lambda a, k: a[0].numel()),
                (cdef, "decide", "cdef_decide", lambda a, k: a[0].numel()),
                (transforms, "fwd_rd_float", "fwd_rd_float",
                 lambda a, k: a[0].numel()),
                (transforms, "inv_txfm", "inv_txfm",
                 lambda a, k: a[0].numel()),
                (deblock, "deblock_pass", "deblock",
                 lambda a, k: a[0].numel())):
            self._wrap(mod, name, key, size)

    def _stage(self, mod, name, stage):
        orig = getattr(mod, name)

        def run(*a, **k):
            self.stage = stage
            try:
                return orig(*a, **k)
            finally:
                self.stage = "wavefront_pass"

        setattr(mod, name, run)
        self._undo.append((mod, name, orig))

    def _wrap(self, mod, name, key, size):
        import torch

        orig = getattr(mod, name)

        def clone(v):
            if isinstance(v, (list, tuple)):
                return type(v)(clone(x) for x in v)
            return v.clone() if torch.is_tensor(v) else v

        def spy(*a, **k):
            n = size(a, k)
            kk_ = key(a, k) if callable(key) else key
            b = bound_ms(*WORK[kk_ if kk_ in WORK else name](a, k))
            self.bounds[self.stage] = self.bounds.get(self.stage, 0.0) + b
            if kk_ not in self.calls or n > self.calls[kk_][0]:
                self.calls[kk_] = (n, tuple(clone(v) for v in a),
                                   {kk: clone(v) for kk, v in k.items()})
            return orig(*a, **k)

        setattr(mod, name, spy)
        self._undo.append((mod, name, orig))

    def restore(self):
        for mod, name, orig in self._undo:
            setattr(mod, name, orig)


def fdct_ties(resid, Fv, FhT, tidx):
    """(B..., m, m) bool: coefficients whose exact (float64) value lies
    within 8x the fp32 error of the plain version (at least 2^-22
    relative) of a rounding tie (.5): there another fp32 summation order
    may round the other way."""
    import torch

    t = tidx.long() if tidx is not None else torch.zeros(
        resid.shape[:-2], dtype=torch.long, device=resid.device)
    y64 = Fv.double()[t] @ resid.double() @ FhT.double()[t]
    y32 = torch.matmul(Fv[t], torch.matmul(resid.float(), FhT[t])).double()
    err = torch.maximum((y32 - y64).abs(), y64.abs() * 2.0 ** -22)
    frac = y64.abs() - y64.abs().floor()
    return (frac - 0.5).abs() <= 8 * err


def make_entry(out: list, counts: dict, frames_per_run: int):
    """A function that prints one kernel's result line and appends its
    entry of the kernels JSON list to `out`; launches are the counts of
    the path the kernel was captured on."""

    def entry(name, source, replaces, err, ms, plain_ms, work,
              library_ms=None):
        nbytes, ops = work
        tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
        print(json.dumps({"kernel": name, "max_abs_diff": err, "ms": ms,
                          "plain_ms": plain_ms, "library_ms": library_ms,
                          "launches_per_frame": counts[name]
                          / frames_per_run, "bound_ms": max(tb, to),
                          "bound_by": "bytes" if tb >= to
                          else "operations"}))
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name], launches_per_frame=counts[name]
            / frames_per_run, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(tb, to), bound_by="bytes" if tb >= to
            else "operations", library_ms=library_ms))

    return entry


def check_fwd_ties(got, ref, a, k, name):
    """K2's parity rule: levels and dequantised values identical except
    at coefficients within the fp32 error bound of a .5 tie (at most
    FDCT_TIE_SHARE of them), the sums close where no tie is.  Returns
    (max |level difference|, share of levels differing)."""
    import torch

    resid, Fv, FhT = a[:3]
    lv, dq, dist, rate = got
    rl, rdq, rdist, rrate = ref
    ties = fdct_ties(resid, Fv, FhT, k.get("tidx"))
    bad = (lv != rl) | (dq != rdq)
    if (bad & ~ties).any():
        raise RuntimeError(f"{name} levels differ away from rounding ties")
    share = float(bad.float().mean())
    if share > FDCT_TIE_SHARE:
        raise RuntimeError(f"{name}: {share:.2e} of levels differ")
    clean = ~ties.flatten(-2).any(-1)
    if not torch.allclose(dist[clean], rdist[clean], rtol=1e-4) or \
            not torch.allclose(rate[clean], rrate[clean], rtol=1e-4):
        raise RuntimeError(f"{name} sums differ from the plain version")
    print(json.dumps({name + "_ties": {
        "blocks": resid.numel() // resid.shape[-1] ** 2,
        "n": resid.shape[-1], "m": Fv.shape[-2], "levels_differing": share,
        "tie_coefficients": float(ties.float().mean())}}))
    return int((lv - rl).abs().max()), share


def check_kernels(calls, counts, frames_per_run):
    """Parity, times and bounds of each kernel on its captured inputs.
    Returns the kernels JSON list."""
    import torch

    from rav1e_tpu_torch.ops import deblock, intra, transforms as tt

    out = []
    entry = make_entry(out, counts, frames_per_run)

    # K1 intra_pred
    _, a, _k = calls["intra_pred"]
    above, left, ha, hl, n, full = a[:6]
    got = intra.intra_pred(*a)
    ref = intra.intra_pred_plain(above, left, ha, hl, n, full)
    err = int((got - ref).abs().max())
    if err:
        raise RuntimeError(f"intra_pred differs from its plain version: {err}")
    entry("intra_pred", "rav1e_tpu_torch/csrc/intra_pred.cu",
          "rav1e_tpu/ops/intra_jax.py:305", err,
          cuda_ms(lambda: intra.intra_pred(*a)),
          cuda_ms(lambda: intra.intra_pred_plain(above, left, ha, hl, n,
                                                 full)),
          WORK["intra_pred"](a, {}))

    # K2 fwd_txq, integer variant (the wavefront's races)
    _, a, k = calls["fwd_txq"]
    resid, Fv, FhT, qdc, qac, shift = a[:6]
    tidx = k.get("tidx")
    qd = tt._as_blocks(qdc, resid)
    qa = tt._as_blocks(qac, resid)
    ti = (tt._as_blocks(tidx, resid) if tidx is not None else
          torch.zeros(resid.shape[:-2], dtype=torch.int32,
                      device=resid.device))
    err, _share = check_fwd_ties(
        tt.fwd_txq(*a, **k),
        tt.fwd_txq_plain(resid, Fv, FhT, ti, qd, qa, shift), a, k, "fwd_txq")
    Fv0, FhT0 = Fv[0], FhT[0]
    xf = resid.float()
    entry("fwd_txq", "rav1e_tpu_torch/csrc/fwd_txq.cu",
          "rav1e_tpu/ops/transforms_jax.py:465", err,
          cuda_ms(lambda: tt.fwd_txq(*a, **k)),
          cuda_ms(lambda: tt.fwd_txq_plain(resid, Fv, FhT, ti, qd, qa,
                                           shift)),
          WORK["fwd_txq"](a, k),
          library_ms=cuda_ms(lambda: torch.matmul(
              Fv0, torch.matmul(xf, FhT0))))

    # K2's float-floor variant (band maps): per-block sums to fp32 order
    _, a, _k = calls["fwd_rd_float"]
    d1, r1, z1 = tt.fwd_rd_float(*a)
    d2, r2, z2 = tt.fwd_rd_float_plain(*a)
    close = (torch.isclose(d1, d2, rtol=1e-3) & torch.isclose(r1, r2, rtol=1e-3)
             & (z1 == z2))
    agree = float(close.float().mean())
    print(json.dumps({"fwd_txq_float_floor": {"blocks": d1.numel(),
                                              "agree": agree}}))
    if agree < 0.99:
        raise RuntimeError(f"fwd_txq float variant agrees on {agree:.3f}")

    # K3 inv_txfm
    _, a, k = calls["inv_txfm"]
    got = tt.inv_txfm(*a, **k)
    coeffs, tx = a[0], a[1]
    if torch.is_tensor(tx):
        ref = torch.empty_like(got)
        types = tx.reshape(coeffs.shape[:-2])
        for t in torch.unique(types).tolist():
            sel = types == t
            ref[sel] = tt.inv_txfm_plain(coeffs[sel], t)
        plain = lambda: [tt.inv_txfm_plain(coeffs[types == t], t)
                         for t in torch.unique(types).tolist()]
    else:
        ref = tt.inv_txfm_plain(coeffs, int(tx))
        plain = lambda: tt.inv_txfm_plain(coeffs, int(tx))
    err = int((got - ref).abs().max())
    if err:
        raise RuntimeError(f"inv_txfm differs from its plain version: {err}")
    entry("inv_txfm", "rav1e_tpu_torch/csrc/inv_txfm.cu",
          "rav1e_tpu/ops/transforms_jax.py:432", err,
          cuda_ms(lambda: tt.inv_txfm(*a, **k)), cuda_ms(plain),
          WORK["inv_txfm"](a, k))

    # K4 deblock (one direction of one plane; the largest is luma)
    _, a, k = calls["deblock"]
    got = deblock.deblock_pass(*a, **k)
    img, lim, blim, thr, pidx, tx, bp, sk, s_al, s_ac = a[:10]
    ref = deblock.deblock_pass_plain(img, lim, blim, thr, 8, pidx, tx, bp, sk,
                                     s_al, s_ac)
    err = int((got - ref).abs().max())
    if err:
        raise RuntimeError(f"deblock differs from its plain version: {err}")
    if torch.equal(got, img.to(torch.int32)):
        raise RuntimeError("deblock filtered nothing")
    entry("deblock", "rav1e_tpu_torch/csrc/deblock.cu",
          "rav1e_tpu/ops/deblock_jax.py:125", err,
          cuda_ms(lambda: deblock.deblock_pass(*a, **k)),
          cuda_ms(lambda: deblock.deblock_pass_plain(
              img, lim, blim, thr, 8, pidx, tx, bp, sk, s_al, s_ac), reps=5),
          WORK["deblock"](a, k))
    check_filter_kernels(calls, entry)
    return out


def _same(got, ref, name) -> int:
    """max |got - ref| over tensors (or tuples of them); raises unless 0."""
    import torch

    pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
    err = max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
              for g, r in pairs)
    if err:
        raise RuntimeError(f"{name} differs from its plain version: {err}")
    return err


def wiener_ties(ds, ss, taps, ref):
    """Where K7's taps differ from the plain version's: each must be 1
    apart at a coefficient whose exact (float64, from exact sums) value
    * 128 lies within WIENER_TIE of a .5 rounding tie."""
    import numpy as np

    from rav1e_tpu_torch.ops import lrf

    diff = (taps != ref).cpu().numpy()
    if not diff.any():
        return 0
    if int((taps - ref).abs().max()) > 1:
        raise RuntimeError("wiener_solve taps differ by more than 1")
    sums = np.concatenate([lrf._normal_sums(d, s).cpu().numpy()
                           for d, s in zip(ds, ss)]).astype(np.float64)
    for i, k in zip(*np.nonzero(diff)):
        m = sums[i]
        M = np.array([[m[0], m[1], m[2]], [m[1], m[3], m[4]],
                      [m[2], m[4], m[5]]])
        M += ((M[0, 0] + M[1, 1] + M[2, 2]) * 1e-6 + 1e-3) * np.eye(3)
        c = np.linalg.solve(M, m[6:])[k] * 128
        if abs(abs(c - np.floor(c)) - 0.5) > WIENER_TIE:
            raise RuntimeError(f"wiener_solve tap ({i}, {k}) differs away "
                               f"from a tie: {c}")
    return int(diff.sum())


def check_filter_kernels(calls, entry):
    """K5-K8 (cdef_dir, cdef_filter, wiener_solve, wiener_lr) on the main
    path's largest calls: parity with the plain versions, times, bounds
    (WORK counts the bytes and operations of each)."""
    import torch

    from rav1e_tpu_torch.ops import cdef, lrf

    # K5 cdef_dir on the deblocked luma
    _, a, _k = calls["cdef_dir"]
    err = _same(cdef.cdef_dir(*a), cdef.cdef_dir_plain(*a), "cdef_dir")
    entry("cdef_dir", "rav1e_tpu_torch/csrc/cdef_dir.cu",
          "rav1e_tpu/ops/cdef_jax.py:43", err,
          cuda_ms(lambda: cdef.cdef_dir(*a)),
          cuda_ms(lambda: cdef.cdef_dir_plain(*a), reps=5),
          WORK["cdef_dir"](a, {}))

    # K6 cdef_filter: the search (8 luma + 3 chroma candidates' superblock
    # SSE) and the apply of the chosen pairs, the frame's two launches
    _, s_a, _k = calls["cdef_filter_search"]
    _, p_a, _k = calls["cdef_filter_apply"]
    err = max(_same(cdef.cdef_filter(*s_a), cdef.cdef_filter_plain(*s_a),
                    "cdef_filter (search)"),
              _same(cdef.cdef_filter(*p_a), cdef.cdef_filter_plain(*p_a),
                    "cdef_filter (apply)"))
    ws, wa = WORK["cdef_filter"](s_a, {}), WORK["cdef_filter"](p_a, {})
    entry("cdef_filter", "rav1e_tpu_torch/csrc/cdef_filter.cu",
          "rav1e_tpu/ops/cdef_jax.py:84", err,
          cuda_ms(lambda: cdef.cdef_filter(*s_a))
          + cuda_ms(lambda: cdef.cdef_filter(*p_a)),
          cuda_ms(lambda: cdef.cdef_filter_plain(*s_a), reps=3)
          + cuda_ms(lambda: cdef.cdef_filter_plain(*p_a), reps=3),
          (ws[0] + wa[0], ws[1] + wa[1]))

    # K7 wiener_solve over the three planes
    _, a, _k = calls["wiener_solve"]
    ds, ss = a
    taps, en = lrf.wiener_solve(ds, ss)
    rt, re = lrf.wiener_solve_plain(ds, ss)
    ties = wiener_ties(ds, ss, taps, rt)
    if not bool((en == re).all()) and not ties:
        raise RuntimeError("wiener_solve en differs from its plain version")
    print(json.dumps({"wiener_solve_ties": ties}))
    entry("wiener_solve", "rav1e_tpu_torch/csrc/wiener_solve.cu",
          "rav1e_tpu/ops/filter_chain_jax.py:25",
          int((taps - rt).abs().max()),
          cuda_ms(lambda: lrf.wiener_solve(ds, ss)),
          cuda_ms(lambda: lrf.wiener_solve_plain(ds, ss), reps=5),
          WORK["wiener_solve"](a, {}))

    # K8 wiener_lr on the luma plane, as the main path called it and with
    # every unit taking Wiener (en on, lam far below 0), so that the whole
    # restored plane is compared and not only the few units content picks
    _, a, _k = calls["wiener_lr"]
    err = _same(lrf.wiener_lr(*a), lrf.wiener_lr_plain(*a), "wiener_lr")
    taps = a[3] if bool(a[3].any()) else torch.tensor(
        [[3, -7, 15]] * 2, dtype=torch.int32, device=a[3].device)
    forced = (*a[:3], taps, torch.ones_like(a[4]), -1e30, *a[6:])
    got, ref = lrf.wiener_lr(*forced), lrf.wiener_lr_plain(*forced)
    err = max(err, _same(got, ref, "wiener_lr (every unit restored)"))
    hh, ww = a[8], a[9]
    if not bool(got[1].all()) or torch.equal(
            got[0], a[0][:hh, :ww].to(torch.int32)):
        raise RuntimeError("wiener_lr with every unit forced to Wiener did "
                           "not restore the plane")
    entry("wiener_lr", "rav1e_tpu_torch/csrc/wiener_lr.cu",
          "rav1e_tpu/ops/lrf_jax.py:77", err,
          cuda_ms(lambda: lrf.wiener_lr(*a)),
          cuda_ms(lambda: lrf.wiener_lr_plain(*a), reps=5),
          WORK["wiener_lr"](a, {}))



def check_inter_kernels(calls, counts, frames_per_run):
    """K9 mc_pred, K10 me_fullpel and K2 with the inter race's thinning on
    the mixed-GOP path's largest calls: parity with the plain versions
    (K9 and K10 identical, K2 by its tie rule), times and bounds.  No
    single PyTorch call computes MC or the motion search (library_ms
    null); K2's is the torch.matmul forward transform.  Returns the
    kernels JSON list."""
    import torch

    from rav1e_tpu_torch.models import device_pipeline as dp
    from rav1e_tpu_torch.ops import mc, transforms as tt

    out = []
    entry = make_entry(out, counts, frames_per_run)

    _, a, k = calls["mc_pred"]
    err = _same(mc.mc_block_batch(*a, **k), mc.mc_block_batch_plain(*a, **k),
                "mc_pred")
    print(json.dumps({"mc_pred_call": {"blocks": int(a[2].numel()),
                                       "w": a[6], "h": a[7], "sub": a[8]}}))
    entry("mc_pred", "rav1e_tpu_torch/csrc/mc_pred.cu",
          "rav1e_tpu/ops/mc_jax.py:71", err,
          cuda_ms(lambda: mc.mc_block_batch(*a, **k)),
          cuda_ms(lambda: mc.mc_block_batch_plain(*a, **k), reps=3),
          WORK["mc_pred"](a, k))

    _, a, k = calls["me_fullpel"]
    err = _same(dp.me_fullpel(*a, **k), dp.me_fullpel_plain(*a, **k),
                "me_fullpel")
    entry("me_fullpel", "rav1e_tpu_torch/csrc/me_fullpel.cu",
          "rav1e_tpu/models/device_pipeline.py:290", err,
          cuda_ms(lambda: dp.me_fullpel(*a, **k)),
          cuda_ms(lambda: dp.me_fullpel_plain(*a, **k), reps=3),
          WORK["me_fullpel"](a, k))

    _, a, k = calls["fwd_txq_thin"]
    resid, Fv, FhT, qdc, qac, shift = a[:6]
    qd, qa = tt._as_blocks(qdc, resid), tt._as_blocks(qac, resid)
    thr = tt._as_blocks(k["thr"], resid, torch.float32)
    ti = torch.zeros(resid.shape[:-2], dtype=torch.int32, device=resid.device)
    plain = lambda: tt.fwd_txq_plain(resid, Fv, FhT, ti, qd, qa, shift,
                                     thr=thr)
    got = tt.fwd_txq(*a, **k)
    err, _share = check_fwd_ties(got, plain(), a, k, "fwd_txq_thin")
    thinned = int((tt.fwd_txq(*a[:6])[0].abs() == 1).sum()
                  - (got[0].abs() == 1).sum())
    print(json.dumps({"fwd_txq_thin_call": {"levels_thinned": thinned}}))
    Fv0, FhT0, xf = Fv[0], FhT[0], resid.float()
    entry("fwd_txq_thin", "rav1e_tpu_torch/csrc/fwd_txq.cu",
          "rav1e_tpu/models/wavefront.py:416", err,
          cuda_ms(lambda: tt.fwd_txq(*a, **k)), cuda_ms(plain),
          WORK["fwd_txq_thin"](a, k),
          library_ms=cuda_ms(lambda: torch.matmul(
              Fv0, torch.matmul(xf, FhT0))))
    return out


def time_cdef_decide(calls) -> dict:
    """The CDEF decision glue (ops/cdef.py decide: a few device torch ops
    between K6's search and apply) timed alone on the main path's last
    call, beside its bound."""
    from rav1e_tpu_torch.ops import cdef

    _, a, k = calls["cdef_decide"]
    nbytes, ops = WORK["cdef_decide"](a, k)
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return {"ms": cuda_ms(lambda: cdef.decide(*a, **k)),
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "superblocks": int(a[0][0].numel())}


def time_stages(targets, secs) -> list:
    """Wrap each (owner, name, key) of `targets` so that every call ends
    in a synchronize and adds its seconds to secs[key] (key may be a
    function of the call's arguments).  Returns the (owner, name, orig)
    list that undoes it."""
    import torch

    undo = []
    for owner, name, key in targets:
        orig = getattr(owner, name)

        def run(*a, _orig=orig, _key=key, **k):
            t = time.perf_counter()
            r = _orig(*a, **k)
            torch.cuda.synchronize()
            kk = _key(a) if callable(_key) else _key
            secs[kk] += time.perf_counter() - t
            return r

        setattr(owner, name, run)
        undo.append((owner, name, orig))
    return undo


def breakdown(frames, profiled: bool) -> dict:
    """One encode of `frames` with a host timer around each device stage
    (each ending in a synchronize, so the stages run serialised): seconds
    per stage and, profiled, the card's busy time by kernel (torch.profiler)
    and its share of the wall time.  The profiler's post-processing of the
    ~10^6 events of a 1080p batch takes minutes, so it runs only on
    request."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rav1e_tpu_torch.models import device_pipeline, wavefront
    from rav1e_tpu_torch.ops import cdef, filter_chain

    secs = Counter()
    undo = time_stages((
        (wavefront, "launch_wavefront_batch", "wavefront_pass"),
        (wavefront, "launch_wavefront", "wavefront_pass"),
        (device_pipeline, "launch_band_rd_maps", "band_maps"),
        (filter_chain, "launch_filter_chain", "filter_chain"),
        (cdef, "search_apply", "cdef"),  # inside the chain
        (filter_chain, "_restore", "lr")), secs)  # inside the chain
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if profiled else contextlib.nullcontext())
    try:
        with prof:
            t0 = time.perf_counter()
            encode(frames, check=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for mod, name, orig in undo:
            setattr(mod, name, orig)
    secs["deblock_and_uploads"] = (secs["filter_chain"] - secs["cdef"]
                                   - secs["lr"])
    out = {"frames": len(frames), "wall_s": wall, "stages_s": dict(secs),
           "encoder_stages_s": encode.stages}
    if not profiled:
        return out

    def dev_us(e):
        for a in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, a):
                return getattr(e, a)
        return 0

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kern) / 1e6
    top = sorted(kern, key=dev_us, reverse=True)[:12]
    out.update(device_busy_s=busy if busy else "not measured",
               device_busy_share=busy / wall if busy else "not measured",
               device_kernels=[{"name": e.key[:80], "calls": e.count,
                                "ms": dev_us(e) / 1e3} for e in top])
    return out


def check_output(data, recon, fes, filter_frames: int):
    """decode == recon where libdav1d loads; SB re-derivation always, and
    the numpy filter chain (deblock_np, cdef_np, lrf_np) over the first
    filter_frames frames.  Returns a summary dict."""
    import numpy as np

    from rav1e_tpu_torch.utils import recon_check

    summary = {}
    try:
        from rav1e_tpu_torch.utils import dav1d_oracle

        dav1d_oracle.Dav1dDecoder().close()
        have_dav1d = True
    except OSError:
        have_dav1d = False
    if have_dav1d:
        dec = dav1d_oracle.decode_stream(data)
        if len(dec) != len(recon):
            raise RuntimeError(f"dav1d decoded {len(dec)} of {len(recon)}")
        for f, (d, r) in enumerate(zip(dec, recon)):
            for p in range(3):
                rp = np.asarray(r[p])
                if not np.array_equal(d[p][: rp.shape[0], : rp.shape[1]],
                                      rp.astype(np.uint8)):
                    raise RuntimeError(f"dav1d decode != recon: frame {f} "
                                       f"plane {p}")
        summary["dav1d"] = "decode == recon, all frames and planes"
    else:
        print("dav1d: libdav1d is absent on this machine; checking by "
              "re-derivation instead")
        summary["dav1d"] = "absent"
    rng = np.random.default_rng(0)
    checked = inter_sbs = 0
    for fe, r in zip(fes, recon):
        wf, pre = fe._chk_wf, fe._chk_prefilter
        refs = fe.refs[1] if wf.has_mv else None  # LAST's output recon
        dev = np.argwhere(wf.geom.device_sb)
        pick = dev[rng.choice(len(dev), min(SB_SAMPLES, len(dev)),
                              replace=False)]
        for sr, sc in pick:
            if not recon_check.rederive_sb(wf, pre, int(sr), int(sc),
                                           fe.dc_q, fe.ac_q, refs):
                raise RuntimeError(f"SB ({sr}, {sc}) does not re-derive")
            checked += 1
            inter_sbs += wf.has_mv and any(
                b[4] == 13 for b in wf.sb_records(int(sr), int(sc)))
    # the first filter_frames frames, or with inter frames the first
    # filter_frames of those
    inter = [f for f, fe in enumerate(fes) if fe._chk_wf.has_mv]
    for f in (inter or list(range(len(fes))))[:filter_frames]:
        fe = fes[f]
        if not recon_check.filters_match(fe, fe._chk_prefilter, recon[f]):
            raise RuntimeError(f"frame {f}: the numpy filter chain over the "
                               "pre-filter frame differs from the output")
    summary["sbs_rederived"] = checked
    summary["sbs_rederived_with_inter_blocks"] = int(inter_sbs)
    summary["filter_chain_np_frames"] = filter_frames
    summary["cdef_per_sb"] = sum(fe.cdef_sb is not None for fe in fes)
    summary["lr_units_wiener"] = sum(
        sum(v is not None for v in getattr(fe, "_lr_params", {}).values())
        for fe in fes)
    return summary


def mixed_gop(card: str) -> list:
    """The mixed-GOP path (phase 8 of the module docstring).  Returns the
    kernels JSON entries of K9, K10 and K2 with thinning."""
    from collections import Counter

    import numpy as np
    import torch

    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.models import wavefront
    from rav1e_tpu_torch.utils.content import make_frames

    frames = make_frames(W, H, MIXED_FRAMES)
    cap = Capture()
    # the passes and phase A timed serialised in this (checked) encode
    secs = Counter()
    undo = time_stages((
        (wavefront, "launch_wavefront",
         lambda a: ("inter_pass" if getattr(a[0], "wf_inter", False)
                    else "key_pass")),
        (wavefront.WavefrontPass, "_inter_phase", "inter_phase_a")), secs)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        data, recon, fes = encode(frames, check=True, mixed=True)
        torch.cuda.synchronize()
    finally:
        cap.restore()
        for owner, name, orig in undo:
            setattr(owner, name, orig)
    t_first = time.perf_counter() - t0
    counts = dict(kernels.COUNTS)
    types = encode.frame_types
    print(json.dumps({"mixed_path_launches": counts,
                      "first_encode_s": t_first, "frame_types": types,
                      "serialised_s": dict(secs), "card": card}))
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the mixed path: "
                           f"{missing}")
    n_inter = sum(fe._chk_wf.has_mv for fe in fes)
    if types.count("inter") != MIXED_FRAMES - 1 or \
            n_inter != MIXED_FRAMES - 1 or len(fes) != MIXED_FRAMES:
        raise RuntimeError(f"{n_inter} inter frames of {types} took the "
                           "inter wavefront")
    # inter blocks and nonzero MVs of the device superblocks' records
    inter_blocks = nonzero_mv = 0
    for fe in fes:
        wf = fe._chk_wf
        if not wf.has_mv:
            continue
        for sr, sc in np.argwhere(wf.geom.device_sb):
            for b in wf.sb_records(int(sr), int(sc)):
                if b[4] == 13:
                    inter_blocks += 1
                    nonzero_mv += (b[16], b[17]) != (0, 0)
    print(json.dumps({"mixed_blocks": {
        "inter_blocks_device_sbs": inter_blocks,
        "inter_blocks_nonzero_mv": nonzero_mv,
        "mode_counts": encode.mode_counts}}))
    if inter_blocks == 0 or nonzero_mv == 0:
        raise RuntimeError("no block chose inter prediction with a motion "
                           "vector")
    print(json.dumps({"mixed_bound_ms_per_frame": {
        k: v / MIXED_FRAMES for k, v in cap.bounds.items()}, "card": card}))
    results = check_inter_kernels(cap.calls, counts, MIXED_FRAMES)
    t1 = time.perf_counter()
    summary = check_output(data, recon, fes, INTER_FILTER_FRAMES)
    print(json.dumps({"mixed_output": summary, "bytes": sum(map(len, data)),
                      "check_s": time.perf_counter() - t1}))
    t2 = time.perf_counter()
    data2, _, _ = encode(frames, check=False, mixed=True)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t2
    if data2 != data:
        raise RuntimeError("the second mixed-GOP encode wrote other bytes")
    print(json.dumps({"mixed_encode": {
        "frames": MIXED_FRAMES, "size": f"{W}x{H}", "seconds": t_enc,
        "fps": MIXED_FRAMES / t_enc, "stages_s": encode.stages,
        "card": card}}))
    return results


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    try:
        from rav1e_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the rav1e_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")

    t0 = time.perf_counter()
    secs = kernels.build_all(force=True)
    t_nvcc = time.perf_counter() - t0
    from rav1e_tpu_torch.ec import native

    t1 = time.perf_counter()
    native.build_native(force=True)
    t_native = time.perf_counter() - t1
    print(json.dumps({"build_s": {"nvcc_parallel": t_nvcc,
                                  "per_kernel": secs,
                                  "native_gxx": t_native}}))
    for name in kernels.KERNELS:
        info = [ln.strip() for ln in kernels.BUILD_LOGS.get(name, "").splitlines()
                if "registers" in ln or "spill" in ln]
        print(json.dumps({"ptxas": name, "info": info}))
    for name in kernels.KERNELS:
        kernels.lib(name)

    from rav1e_tpu_torch.utils.content import make_frames

    frames = make_frames(W, H, NFRAMES)
    cap = Capture()
    kernels.reset_counts()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    try:
        data, recon, fes = encode(frames, check=True)
        torch.cuda.synchronize()
    finally:
        cap.restore()
    t_first = time.perf_counter() - t2
    counts = dict(kernels.COUNTS)
    print(json.dumps({"main_path_launches": counts,
                      "first_encode_s": t_first}))
    # the keyframe path runs K1-K8 (K9, K10 and the thinning run on inter
    # frames, phase 8)
    missing = [k for k in kernels.KERNELS[:8] if counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")
    if len(fes) != NFRAMES:
        raise RuntimeError(f"{len(fes)} of {NFRAMES} frames took the "
                           "wavefront")

    print(json.dumps({"bound_ms_per_frame": {
        k: v / NFRAMES for k, v in cap.bounds.items()}, "card": card}))
    results = check_kernels(cap.calls, counts, NFRAMES)
    t3 = time.perf_counter()
    summary = check_output(data, recon, fes, FILTER_FRAMES)
    print(json.dumps({"output": summary, "bytes": sum(map(len, data)),
                      "check_s": time.perf_counter() - t3}))

    # the keyframe path with CDEF and loop restoration off
    kernels.reset_counts()
    off_data, off_recon, off_fes = encode(frames[:OFF_FRAMES], check=True,
                                          filters=False)
    torch.cuda.synchronize()
    off_counts = dict(kernels.COUNTS)
    missing = [k for k in kernels.KERNELS[:4] if off_counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the cdef/lrf-off path: "
                           f"{missing}")
    off_summary = check_output(off_data, off_recon, off_fes, OFF_FRAMES)
    print(json.dumps({"off_path": {"launches": off_counts,
                                   "output": off_summary,
                                   "bytes": sum(map(len, off_data))}}))

    t4 = time.perf_counter()
    data2, _, _ = encode(frames[:KEY_TIMED], check=False)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t4
    if data2 != data[:KEY_TIMED]:
        raise RuntimeError("the second encode wrote other bytes")
    print(json.dumps({"encode": {"frames": KEY_TIMED, "size": f"{W}x{H}",
                                 "seconds": t_enc, "fps": KEY_TIMED / t_enc,
                                 "stages_s": encode.stages, "card": card}}))
    print(json.dumps({"breakdown": breakdown(frames[:4],
                                             "--profile" in sys.argv),
                      "card": card}))
    print(json.dumps({"cdef_decide": time_cdef_decide(cap.calls),
                      "card": card}))
    results += mixed_gop(card)
    print(json.dumps({"parity": {r["name"]: r["max_abs_err"]
                                 for r in results}}))
    if any(m == "jax" or m.startswith("jax.") or m == "rav1e_tpu"
           or m.startswith("rav1e_tpu.") for m in sys.modules):
        raise RuntimeError("the JAX package or jax was imported")
    print(json.dumps({"kernels": results}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
