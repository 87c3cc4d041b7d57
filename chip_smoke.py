#!/usr/bin/env python3
"""Smoke run of rav1e_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--save-stream DIR]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the fifteen CUDA kernels (csrc/*.cu, one nvcc each, in parallel)
   and the native entropy library, and prints the build seconds.
3. Drives the main path once: NFRAMES key frames of 1920x1080 through
   Config -> Context in bench.py's keyframe configuration (speed-6
   defaults, so CDEF and loop restoration on; quantizer 100, low
   latency).  Every kernel's launch count is set to 0 just before and
   read just after; each of the eight must have launched, and K15
   cdef_decide once a frame (each runs CDEF) while the plain decision
   never runs.
4. Holds each kernel against its plain PyTorch version on the card, on the
   inputs the main path gave it (the largest call of each):
   intra_pred, inv_txfm, deblock, cdef_dir, cdef_filter (search and
   apply), wiener_lr (also with every unit forced to take Wiener),
   wiener_solve (taps and en; a tap 1 apart would have to sit within
   1e-9 of a .5 tie) and cdef_decide must be identical (every call of
   wiener_solve, cdef_decide, cdef_filter and, where they run, mc_pred's
   and cfl's calls (its fit and its decide mode) too: check_every, on
   every path that keeps a Capture, after the path's counted encode, the
   kernels launched again on the kept inputs);
   fwd_txq's levels and dequantised values identical except where the
   exact coefficient lies within the fp32 error bound of a .5 rounding
   tie, and such coefficients may be at most FDCT_TIE_SHARE of them.
   Times each (CUDA events, warmed) beside its plain version, its bound
   and, for fwd_txq, the torch.matmul forward transform; for fwd_txq
   also its launches alone and the transform's (device_ms,
   library_device_ms: 20 calls captured in one CUDA graph, the replay
   timed), the key race's call over its first block alone (the device
   time that does not grow with the blocks), and the largest sums-only
   call (the 13-candidate mode race, levels=False), whose sums must
   equal the full call's, with its bound with and without the levels.
   intra_pred's entry is the key pass's largest race (the fine-direction
   pick of the 32x32 leaves), inv_txfm's the pass's largest call (the
   64x64 root's fused reconstruction from its 32x32 corner), each with
   device_ms (graph_ms) and host_ms (the wrapper's issue time: 100 calls
   with no synchronize between them) beside ms; the largest of K1's
   channel-list and U+V calls and of K3's fused, 64x64 and per-type
   calls are held against their plain versions and timed on a line of
   their own (k1_k3_modes), as they are, untimed, on phases 8, 9, 10, 12
   and 13.  wiener_solve, cdef_decide (its entry also with the plain
   decision's device time by torch.profiler), deblock, cdef_dir,
   cdef_filter (its search and apply each on a line of their own,
   cdef_filter_calls), wiener_lr and, on their paths, mc_pred, me_fullpel
   and cfl carry device_ms and host_ms beside ms.
5. Checks the output: with libdav1d present the stream decodes to the
   encoder's recon; in every case 16 sampled superblocks a frame re-derive
   from their records with the numpy oracles onto the pre-filter recon,
   and on FILTER_FRAMES frames deblock_np, cdef_np with each superblock's
   strengths and lrf_np's Wiener filter on the chosen units, over the
   pre-filter frame, give the output recon exactly.  Prints each frame's
   recon SHA-256 and its restoring LR units on the bottom unit row (with
   --save-stream, writes DIR/key.ivf and DIR/key_recon.json).
6. Drives the keyframe path with CDEF and loop restoration off on
   OFF_FRAMES frames, with the counts set to 0 before it: K1-K4 must
   launch, and its output is checked the same way.
7. Times a second encode of the first KEY_TIMED frames of the main path
   (frames/s), then an encode of the first BREAKDOWN_FRAMES with each
   device stage
   timed serialised (wavefront pass, band maps, the filter chain and,
   inside it, CDEF and LR); with --profile also under torch.profiler (the
   card's busy time by kernel; minutes).
8. Drives the mixed-GOP path: bench.py's mixed configuration (its GOP
   cut to MIXED_FRAMES frames of 1920x1080: 1 key + 2 inter,
   max_key_frame_interval 240, low latency, speed-6 defaults), with the
   counts set to 0 before it.  All inter frames must take the inter
   wavefront, every kernel
   but the speed-5 path's must launch (K9 mc_pred, K10 me_fullpel and
   fwd_txq with thinning among them; K9 6 times an inter frame: each
   level's luma race in the residual mode and its U and V in one launch;
   K15 once a frame), and
   blocks must choose inter prediction with nonzero MVs.  Holds K9 (its
   largest race call and U + V call, mc_pred_calls) and
   K10 (identical) and fwd_txq with thinning (the tie rule) against their
   plain versions on the path's largest calls, timed beside their bounds
   (fwd_txq with thinning also sums-only, and sums-only over one
   residual, to split its device time); re-derives sampled superblocks of every frame (inter blocks by mc_np
   from the reference's output recon) and INTER_FILTER_FRAMES inter frames
   through deblock_np, cdef_np and lrf_np; a second encode of the first
   MIXED_TIMED frames must write the same bytes, and gives the mixed
   GOP's frames/s and stage seconds.
9. Drives the speed-5 path: bench.py's keyframe configuration at
   SpeedSettings.from_preset(5) (CFL in the pass, the host deblock level
   search, the CDEF search outside the chain, the SGR and per-unit Wiener
   LR search), SPEED5_FRAMES frames, with the counts set to 0 before it:
   K1-K3, K5, K6, K8 in frame mode and K11 cfl must launch (K15 once a
   frame), K4 deblock and
   K7 wiener_solve must not. Holds K11 (its fit and its decide mode, the
   CFL-vs-DC choice) and K8's frame mode (stripes 64 and 32) against their
   plain versions, timed beside their bounds; counts with torch.profiler
   the device operations one call of the wavefront's CFL arm (the largest)
   issues, at most CFL_ARM_MAX_OPS, and those of the leaf's chroma around
   it, and times the arm (cfl_arm); times the CDEF search outside the
   chain; re-derives sampled superblocks and
   FILTER_FRAMES frames through deblock_np, cdef_np and lrf_np / sgr_np
   with the coded parameters, and counts the restoration units by kind.
   Then CFL_FRAMES frames of content whose chroma follows its luma (the
   bench content seldom picks CFL): CFL must win blocks, and the
   superblocks holding them re-derive. A timed second encode of
   SPEED5_TIMED frames must write the same bytes; a 320x240 key frame
   takes the small-frame CDEF route (_cdef_search, cdef_frame_device); a
   GOP of 1 key + 1 inter frame at speed 5 takes the inter pass.
10. Drives the default configuration: EncoderConfig(width=1920,
   height=1080, quantizer=100, rdo_lookahead_frames=8), everything else
   at its defaults (low_latency=False: pyramid sub-GOPs of 4 with
   multiref, show_existing_frame packets), DEFAULT_FRAMES frames, with the
   counts set to 0 before it.  Prints each inter frame's path (the inter
   wavefront or the host inter path), references, reference_select,
   compound block count, interpolation filter and LR types.  The first
   ALTREF must take the inter wavefront, some host frame must code
   compound blocks, some frame must reference GOLDEN or LAST2, and K10
   must run through frame_me_map once for each reference of each host
   frame, every call identical to me_fullpel_plain on the same card
   tensors (the largest timed beside its bound).  Re-derives the
   wavefront frames' sampled superblocks and DEFAULT_FILTER_FRAMES host
   frames through deblock_np, cdef_np and lrf_np with the coded
   parameters; prints each displayed frame's recon SHA-256 (with
   --save-stream, writes the stream and the digests to DIR for
   rav1e_tpu_torch/utils/stream_check.py to decode where libdav1d is);
   gives the counted encode's frames/s and stage seconds (me_maps,
   interp_probe, host_walk, deblock_host, cdef_host, lr_decide, lr_emit).
11. Drives the path above 8 bits: EncoderConfig(width=1920, height=1080,
   quantizer=100, rdo_lookahead_frames=8, bit_depth=10), HBD_FRAMES
   frames of 10-bit bench content (1 key + a sub-GOP of 2), with the
   counts set to 0 before it.  No frame may take the wavefront or the
   chain (K4, K7, K9, K11 and the pass's K3 and K10 idle): the key frame
   must take frame_rd_maps (K1 and K2's float variant twice each), the
   inter frames the host inter path with K10 through frame_me_map on
   uint16 planes once a reference, every frame the CDEF search on the
   card at 10 bits (K5, K6) and K8's frame mode at 10 bits.  Holds every
   K5, K6, K8 and K10 call of the path against its plain version on the
   same card tensors (identical), and frame_rd_maps against the same
   route through the plain versions (modes, nnz, split32 identical but at
   counted near-ties); times each route beside its bound (frame_rd_maps'
   K2 beside the torch.matmul transform); then K5, K6, K8 (stripes 64
   and 32) and K10 on seeded 12-bit 1920x1088 planes with maximum-contrast
   blocks, a 320x240 12-bit key + inter encode and a 320x240 8-bit
   lossless key frame (through FrameEncoder: the Context refuses
   quantizer 0, ROADMAP F6); re-derives HBD_FILTER_FRAMES frames through
   deblock_np, cdef_np and lrf_np at 10 bits; prints the recon digests
   (16-bit samples; --save-stream writes DIR/hbd.ivf and
   DIR/hbd_recon.json); gives the counted encode's frames/s and stage
   seconds.
12. Drives the speed-3 path: bench.py's keyframe configuration at
   SpeedSettings.from_preset(3) (the pass's 8x8 level: each 16x16 leaf
   raced against its four 8x8 leaves; then speed 5's host filter path),
   SPEED3_FRAMES frames (frame 0's pass alone, then one batch of 2), with
   the counts set to 0 before it, the encode timed (frames/s, stage
   seconds).  K1-K3, K5, K6, K8's frame mode and K11 must launch, K4 and
   K7 must not; every frame must choose 8x8 leaves.  Holds the largest
   call of each shape the 8x8 level adds (K1 8x8 with the full channel
   set and 4x4 non-directional, K2 and K3 over the 8x8 luma tx-type race
   and the 4x4 uv race, K11 on 8x8 luma) against its plain version, timed
   beside it,
   its bound and, for K2, the torch.matmul transform; re-derives up to
   SPLIT8_SAMPLES superblocks a frame holding 8x8 leaves (with
   --save-stream, writes DIR/speed3.ivf and DIR/speed3_recon.json); times
   the pass of one batched frame alone, which must write its batch
   slot's records; and runs the CLI (`python -m rav1e_tpu_torch ... -s 3
   --psnr --reconstruction`, its main() here) on a CLI_FRAMES-frame
   CLI_SIZE clip: the key frame re-derives through the numpy filters onto
   the written y4m, and the printed PSNR is frame_psnr's.
13. Drives the tile route: TILE_FRAMES key frames of 2560x1600 (WQXGA,
   40 x 25 superblocks) in bench.py's keyframe configuration (at
   EncoderConfig's default tune, psychovisual) with tile_cols=4 and
   Config(threads=4), with the counts set to 0 before it.
   Every frame must take the tile route (the pass over the 4 tile
   columns' stacked lanes, parallel/tiles.py: `wavefront_tiles` counts
   each), K1-K3 and the host filter path's K5 and K6 must launch, K4, K7
   and K8's chain mode must not (the route has no device-resident recon).
   The same frames at threads=0 (the single-device pass) must give the
   same bytes, recon and per-superblock records.  Holds the route's
   largest K1, K2 and K3 calls against their plain versions, timed beside
   their bounds; re-derives TILE_EDGE_SAMPLES superblock rows on both
   sides of each tile boundary and frame 0 through deblock_np, cdef_np
   and lrf_np (with --save-stream, writes DIR/tiles.ivf and
   DIR/tiles_recon.json); times one frame's pass alone on each route
   (58 steps of 20 lanes against 88 of 20); and runs the CLI with
   --shard-dir on a RESUME_FRAMES-frame RESUME_SIZE clip with key frame
   interval 1, stopped after one segment and resumed: its stream must
   equal an uninterrupted run's.
14. Drives the multi-device half of parallel/: prints the visible GPUs
   and the slots (distinct GPUs where several are visible, else slots
   sharing cuda:0).  With the counts set to 0 before it, deblock_sharded
   over MULTI_SHARDS shards runs on phase 13's first frame (its three
   pre-filter planes, DeblockInfo and levels: luma slabs of 640 columns,
   chroma of 320) and on one seeded 10-bit 2560x1600 plane of flat
   patches; K4 must launch (its launches counted on this path).  Each
   result, and that of a seeded 12-bit plane after the path, must be
   identical to K4's single-device deblock_plane, to its plain version
   on the card and to the serial deblock_np.  Times the sharded and the
   single-device deblock (CUDA events) beside the bytes bound.  Then
   frame 0 of phase 13's clip through Config(threads=4) with the
   Context's mesh on MULTI_SLOTS slots (two GPUs where two are visible,
   else both on cuda:0): bytes, recon and its 1,000 superblock records
   must equal phase 13's one-slot route's; and dryrun_multidevice
   (parallel/dryrun.py) over MULTI_SHARDS slots.
15. Drives the LR decision of a chain without its fused stage (PERF.md
   row 9b) and the source-edge analysis functions, each path with the
   counts set to 0 before it.  LR_UNFUSED_FRAMES 1080p bench key frames
   at bench.py's speed-6 defaults with RAV1E_TPU_LR_FUSE=0 (set for the
   encode, restored after): K7 and K8's chain mode must not launch, K8
   must launch 3 times a frame on the unfused route (wiener_lr_decide),
   every such call identical to wiener_lr_plain; frames/s beside phase
   7's fused rate; --save-stream writes DIR/lr_unfused.ivf and
   DIR/lr_unfused_recon.json.  K12 (mode_sad): frame_mode_maps of a
   bench luma plane padded to 1920x1088 and its sharded form over
   ANALYSIS_SHARDS slots (slabs of 256 and 288 rows at n = 32, of 272 at
   n = 16), intra_analysis_step
   on its 510 superblocks and its sharded form, all identical to the
   plain version.  K13 (dr_predict): all 56 angles at each of DR_SHAPES,
   predict_stack (K1 + K13) at n = 4 to 32.  K14 (build_edges): EDGE_LANES
   blocks of every availability.  put_single_batch (K9) on luma, 4:2:0
   chroma and a 10-bit plane with the SHARP filter set.  Each identical
   to its plain version, and its largest call timed beside the plain
   version and its bound.
16. Drives the segmentation GOP: SEG_FRAMES frames of SEG_SIZE in the
   mixed GOP's configuration with EncoderConfig(segmentation_aq=True),
   with the counts set to 0 before it: the key frame codes segment ids,
   the P frames take the inter wavefront (K1-K3, K9, K10 and K2's
   thinning must launch); the P frames' superblocks re-derive and the
   last one's numpy filter chain gives its output (with --save-stream,
   writes DIR/seg.ivf and DIR/seg_recon.json).
17. Holds K6 against its plain version on seeded K6_EDGE_SIZE planes
   (1080x1000: partial superblocks on the bottom row and the right
   column) at 8, 10 and 12 bits with random, all-inactive and all-active
   block maps (search and apply), every candidate pair applied to every
   superblock, and cdef_frame_device on the card against its CPU route.

Before the kernels line it prints the wall seconds of phases 1-7
together and of each later phase (phase_wall_s), and nvcc's ptxas lines
of every kernel's entry functions (each instantiation: registers, stack
frame, spills) after the build; K1, K3, K7, K9 and K15 must report no
stack frame and no spills.  The line before the
last is the card's name and power limit; the last is
{"ok": true, "device": {...}}.  Any failed phase exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

# depth cuts that keep the script inside half its time limit (PERF.md
# section 4): every path keeps its configuration and frame size, and runs
# fewer frames
W, H, NFRAMES = 1920, 1080, 3  # key frames of the main path
MIXED_FRAMES = 3  # bench.py's mixed GOP cut to 1 key + 2 inter
MIXED_TIMED = 2  # frames of the mixed GOP's timed second encode
SPEED5_FRAMES = 1  # key frames of the speed-5 path (phase 9)
SPEED5_TIMED = 1  # frames of the speed-5 path's timed second encode
DEFAULT_FRAMES = 5  # EncoderConfig()'s pyramid: 1 key + one sub-GOP of 4
#                     (the first ALTREF on the inter wavefront, 3 host
#                     frames with LAST2 and compound references)
DEFAULT_FILTER_FRAMES = 1  # host frames re-derived through the numpy filters
CFL_FRAMES = 1  # speed-5 key frames of content whose chroma follows luma
GOP5_FRAMES = 2  # the speed-5 GOP: 1 key + 1 inter
KEY_TIMED = 2  # frames of the keyframe path's timed second encode
BREAKDOWN_FRAMES = 1  # frames of the keyframe path's stage breakdown
SB_SAMPLES = 16
FILTER_FRAMES = 1  # frames whose whole filter chain is re-derived in numpy
INTER_FILTER_FRAMES = 1  # inter frames of the mixed GOP re-derived so
OFF_FRAMES = 1  # frames of the CDEF/LR-off path
WIENER_TIE = 1e-9  # |coef * 128 - (k + .5)| where a tap may round apart
FDCT_TIE_SHARE = 1e-3
RD_TIE = 1e-5  # relative gap of two RD costs that fp32 order may flip
HBD_FRAMES = 3  # EncoderConfig()'s pyramid cut to 1 key + a sub-GOP of 2
#                 (the ALTREF, then a host frame with compound references);
#                 phases 10 and 11 time their counted encode (the captures
#                 cost no measurable time: the card timed both) and run
#                 no second encode
HBD_BD = 10
HBD_FILTER_FRAMES = 1  # frames re-derived through the numpy filters
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


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of fn: `reps` calls captured in one CUDA
    graph (inputs made before, outputs allocated at capture from the
    graph's pool), the replay timed with CUDA events, so the host's issue
    time drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def host_ms(fn, reps: int = 100) -> float:
    """The host's issue time of one call of fn: `reps` calls back to back
    with no synchronize between them (the card runs behind), the host
    clock around them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def profiler_ms(fn, reps: int = 20):
    """Device time of one call of fn for calls a CUDA graph cannot capture
    (a host-to-device copy inside): the self device time of every kernel
    torch.profiler records over `reps` calls, summed; None where the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:  # a measurement, not a check: say so
        print(json.dumps({"profiler_ms": f"not measured: {e}"}))
        return None
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages())
    return us / reps / 1e3 if us else None


def timed(call, reps: int = 20) -> dict:
    """A call's eager ms (cuda_ms, the host's issue time included),
    device_ms (graph_ms) and host_ms."""
    return {"ms": cuda_ms(call, reps), "device_ms": graph_ms(call, reps),
            "host_ms": host_ms(call)}


K2_EAGER_REPS = 100  # back-to-back calls a K2 ms: the host's issue time
#                     varies from call to call on a shared host


def fwd_times(call, a) -> dict:
    """K2's times on one call's arguments `a`: the wrapper as the pass
    calls it (ms: K2_EAGER_REPS back-to-back calls, the host's issue time
    included) and its launches alone (device_ms, graph_ms), beside one
    PyTorch call of the same forward transform, torch.matmul over the same
    blocks with the first matrix pair, timed both ways (library_ms,
    library_device_ms)."""
    import torch

    resid, Fv, FhT = a[:3]
    Fv0, FhT0 = (Fv[0], FhT[0]) if Fv.dim() == 3 else (Fv, FhT)
    xf = resid.float()
    lib = lambda: torch.matmul(Fv0, torch.matmul(xf, FhT0))
    return {"ms": cuda_ms(call, K2_EAGER_REPS), "device_ms": graph_ms(call),
            "library_ms": cuda_ms(lib, K2_EAGER_REPS),
            "library_device_ms": graph_ms(lib)}


@contextlib.contextmanager
def checked(check: bool = True):
    """While open (and check is true), every frame encoder keeps its
    pre-filter planes (_chk_prefilter), output recon (_chk_out) and
    wavefront records (_chk_wf).  Yields (the encoders that took a
    wavefront, every encoder), in coding order."""
    from rav1e_tpu_torch.models import inter_frame, intra_frame
    from rav1e_tpu_torch.ops import filter_chain

    seen = []
    all_fes = []
    orig_splice = filter_chain._splice
    orig_tiles = intra_frame.IntraFrameEncoder._encode_tiles_wavefront
    orig_install = inter_frame.InterFrameEncoder._install_wavefront
    orig_finish = intra_frame.IntraFrameEncoder._finish_encode

    def finish(self):
        # the host filter path (the deblock search at speed <= 5): the
        # pre-filter planes are the recon before the host deblocks it
        if not hasattr(self, "_chk_prefilter"):
            hh, ww = self.coded_h, self.coded_w
            self._chk_prefilter = [
                self.rec[0][:hh, :ww].copy(),
                self.rec[1][: hh >> 1, : ww >> 1].copy(),
                self.rec[2][: hh >> 1, : ww >> 1].copy()]
        out = orig_finish(self)
        self._chk_out = out[1]
        all_fes.append(self)
        return out

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
        intra_frame.IntraFrameEncoder._finish_encode = finish
    try:
        yield seen, all_fes
    finally:
        filter_chain._splice = orig_splice
        intra_frame.IntraFrameEncoder._encode_tiles_wavefront = orig_tiles
        inter_frame.InterFrameEncoder._install_wavefront = orig_install
        intra_frame.IntraFrameEncoder._finish_encode = orig_finish


def encode(frames, check: bool, device: str = "cuda",
           filters: bool = True, mixed: bool = False, speed: int = 6,
           size=None, default: bool = False, bit_depth: int = 8,
           tile_cols: int = 0, threads: int = 0, tune=None,
           seg: bool = False):
    """Encode `frames` through the public API on `device`, in bench.py's
    keyframe configuration (filters=False: with CDEF and loop restoration
    off), or with mixed in its mixed-GOP configuration (a key frame, then
    inter frames), or with default at EncoderConfig()'s defaults
    (low_latency=False: pyramid sub-GOPs, multiref, show_existing_frame
    packets), at SpeedSettings.from_preset(speed), W x H (or size) and
    bit_depth, with tile_cols tile columns and Config(threads=threads)
    (threads > 1 and tile_cols > 1: the key frames' tile route), with seg
    segmentation_aq on, and, if given, tune (EncoderConfig's own default
    otherwise).  With
    check, keep each frame's pre-filter planes, output recon and wavefront
    records; the encoders that took a wavefront are returned in coding
    order, and every encoder in encode.all_fes."""
    from rav1e_tpu_torch import Config, EncoderConfig, SpeedSettings
    from rav1e_tpu_torch.api.context import EncoderError, EncoderStatus

    w, h = size or (W, H)
    ss = SpeedSettings.from_preset(speed)
    if not filters:
        ss.cdef = False
        ss.lrf = False
    if default:
        enc = EncoderConfig(width=w, height=h, quantizer=100,
                            rdo_lookahead_frames=8, speed_settings=ss,
                            bit_depth=bit_depth)
    elif mixed:
        enc = EncoderConfig(width=w, height=h, quantizer=100,
                            max_key_frame_interval=240,
                            rdo_lookahead_frames=8, low_latency=True,
                            speed_settings=ss, bit_depth=bit_depth)
    else:
        enc = EncoderConfig(
            width=w, height=h, quantizer=100, min_key_frame_interval=1,
            max_key_frame_interval=1, rdo_lookahead_frames=8,
            low_latency=True, speed_settings=ss, bit_depth=bit_depth)
    enc.tile_cols = tile_cols
    enc.segmentation_aq = seg
    if tune is not None:
        enc.tune = tune
    cfg = Config(enc=enc, device=device, threads=threads)
    with checked(check) as (seen, all_fes):
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
    if len(pkts) != len(frames) and not default:
        raise RuntimeError(f"{len(pkts)} packets for {len(frames)} frames")
    recon = [ctx._encoder.recon_by_input[i] for i in range(len(frames))]
    encode.stages = dict(ctx._encoder.stats.stage_seconds)
    encode.mode_counts = dict(ctx._encoder.stats.mode_counts)
    encode.cfl_blocks = ctx._encoder.stats.cfl_blocks
    encode.frame_types = [p.frame_type for p in pkts]
    encode.key_routes = dict(ctx._encoder.stats.key_routes)
    encode.all_fes = all_fes
    return [p.data for p in pkts], recon, seen


def _unique_bytes(t) -> int:
    """Bytes of the distinct elements of a tensor view: a broadcast
    (zero-stride) dimension is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n * t.element_size()


def _fwd_work(a, k, levels: bool, nnz: bool = False):
    """K2's (bytes, operations): the residual, the matrices and the
    per-block quantisers, keys and thresholds read once (a broadcast one
    once), the levels and dequantised values (where the call writes
    them), dist and rate (and nnz) written; 2 m n (n + m) flops a block."""
    import torch

    resid, Fv, FhT = a[0], a[1], a[2]
    n, m = resid.shape[-1], Fv.shape[-2]
    nb = resid.numel() // (n * n)
    ins = _unique_bytes(resid) + (Fv.numel() + FhT.numel()) * 4 + sum(
        _unique_bytes(v) for v in (a[3], a[4], k.get("tidx"), k.get("thr"))
        if torch.is_tensor(v))
    return (ins + nb * ((m * m * 8 if levels else 0) + 8 + 4 * nnz),
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
    sc = (a[12] if len(a) > 12 else 8) - 8  # strengths << (bd - 8)
    nb, nsb = dirs.numel(), -(-h // 64) * -(-w // 64)

    def ops(pri, sec, samples):  # per-block strengths, samples a block
        pos = lambda t: torch.as_tensor(t, device=act.device) > 0
        taps = (4 * pos(pri) + 8 * pos(sec)) * act
        return int(((taps * CDEF_TAP_OPS + (taps > 0) * CDEF_OUT_OPS)
                    * samples).sum())

    if a[10] == cdef.SEARCH:
        n = sum(ops(cdef._adjust(p << sc, var), s, 64)
                for p, s in cdef.Y_CANDIDATES)
        n += sum(ops(p, 0, 32) for p, _ in cdef.UV_CANDIDATES)
        n += (ny * len(cdef.Y_CANDIDATES) + nc * len(cdef.UV_CANDIDATES)) \
            * SSE_OPS
        return (ny + nc) * 8 + nsb * 88 + nb * 9, n
    nby, nbx = dirs.shape
    idx_b = a[11].long().repeat_interleave(8, 0) \
        .repeat_interleave(8, 1)[:nby, :nbx]
    ypri, ysec, _, uvpri, _ = cdef._cand_maps(dirs, var, idx_b, sc)
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


def _rect_union(shape, y, x, hh: int, ww: int) -> int:
    """Samples of a (H, W) plane under the union of the hh x ww
    rectangles at (y, x) (a difference map, summed twice)."""
    import torch

    H, W = shape
    d = torch.zeros((H + 1, W + 1), dtype=torch.int32, device=y.device)
    y0, x0 = y.long().clamp(0, H), x.long().clamp(0, W)
    y1, x1 = (y.long() + hh).clamp(0, H), (x.long() + ww).clamp(0, W)
    one = torch.ones_like(y0, dtype=torch.int32)
    for yy, xx, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                         (y1, x1, 1)):
        d.index_put_((yy, xx), one * sign, accumulate=True)
    return int((d.cumsum(0).cumsum(1)[:H, :W] > 0).sum())


def _mc_work(a, k):
    """Bytes and operations of one K9 launch in any mode: each plane's
    windows read once (the union of its blocks' (h + 7) x (w + 7) windows
    on the padded plane), the source blocks once in the residual mode
    (their union), two int32 words a position and two an MV, and each
    int32 output (prediction, residual or both, a plane each) written
    once; the two passes over each block's samples, and a subtraction a
    sample in the residual mode."""
    import torch

    refs = a[0] if isinstance(a[0], (tuple, list)) else (a[0],)
    margin, px, py, mvr, mvc, w, h, sub_x, sub_y = a[1:10]
    src, cands = k.get("src"), k.get("cands", 1)
    srcs = None if src is None else (src if isinstance(src, (tuple, list))
                                     else (src,))
    P, n, elt = len(refs), mvr.numel(), refs[0].element_size()
    pos = torch.arange(n, device=mvr.device) // cands
    ix = (((px.long()[pos] << 4) + (mvc.long() << (1 - sub_x))) >> 4) \
        - 3 + margin
    iy = (((py.long()[pos] << 4) + (mvr.long() << (1 - sub_y))) >> 4) \
        - 3 + margin
    nbytes = (P * _rect_union(refs[0].shape, iy, ix, h + 7, w + 7) * elt
              + px.numel() * 8 + n * 8)
    outs = (srcs is None or k.get("both", False)) + (srcs is not None)
    nbytes += outs * P * n * h * w * 4
    if srcs is not None:
        nbytes += P * _rect_union(srcs[0].shape, py, px, h, w) * elt
    return (nbytes, P * n * ((h + 7) * w * MC_PASS_OPS[0] + h * w
                             * (MC_PASS_OPS[1] + (srcs is not None))))


def _me_work(a, k):
    """Bytes and operations of one K10 call (its two launches): both
    planes read once (uint8 or uint16), two int32 words a 32x32 block out;
    the 4x4 sums of both planes, the 289 quarter-resolution SADs of 64
    terms and the 25 full-resolution SADs of 1024 terms a block, and both
    argmins."""
    src, ref = a[0], a[1]
    hh, ww = src.shape
    nb = (hh // 32) * (ww // 32)
    return ((src.numel() + ref.numel()) * src.element_size() + nb * 8,
            2 * (hh * ww // 16) * 15 + nb * (289 * 64 + 25 * 1024) * SAD_OPS
            + nb * (289 + 25) * 2)


def _wiener_frame_work(a, k):
    """Bytes and operations of one K8 launch in frame mode: the CDEF output
    read once, the deblocked plane in the rows the stripe rule takes, the
    restored plane written (int32); the horizontal pass over each distinct
    source row and the vertical pass over each sample."""
    import numpy as np

    from rav1e_tpu_torch.ops import lrf

    stripe, hh, ww = a[3], a[4], a[5]
    ridx, use_db = lrf.stripe_table(hh, stripe)
    db_rows = np.unique(ridx[use_db]).size
    return (hh * ww * 8 + db_rows * ww * 4 + 24,
            (hh + db_rows) * ww * WIENER_PASS_OPS + hh * ww * WIENER_PASS_OPS)


CFL_OPS = 31  # an AC sample: the 2x2 sum and shift, the mean, ac^2 and the
#               two planes' residual products; then per plane the scaled
#               prediction (multiply, magnitude, round, sign, add, clip)
#               and the residual


def _cfl_work(a, k):
    """Bytes and operations of one K11 launch: the int32 luma blocks, the
    DC predictions and the sources of both planes read; both planes'
    predictions and residuals and two alphas a block written."""
    luma, dc = a[0], a[1]
    return (luma.numel() * 4 + dc.numel() * 16 + luma.shape[0] * 8,
            dc.numel() // 2 * CFL_OPS)


def _cfl_decide_work(a, k):
    """Bytes and operations of one K11 decide launch: the CFL residual and
    its inverse read, then for each block and plane the cheaper side's
    blocks (the CFL prediction and levels: DC's side reads three); the
    chosen blocks written; the per-plane costs, rates and alphas, lam and
    the mode read, rates, alphas and the uv mode written; the SSE's 3
    operations a sample."""
    rc = a[0]
    return (rc.numel() * 4 * 7 + rc.shape[0] * (2 * 5 * 4 + 4 + 8 + 8),
            rc.numel() * SSE_OPS)


def _decide_work(a, k):
    """Bytes and operations of K15 (ops/cdef.py decide): the 11 candidates'
    superblock SSE (int64) and the per-mi skip map read once, use_sb,
    frame_best and the per-SB index map written; the joint costs, their
    per-SB and frame sums and argmins over the 8 pairs, and a test a mi."""
    sse, skip = a[0], a[1]
    nsb = sse[0].numel()
    return (sse.numel() * sse.element_size()
            + skip.numel() * skip.element_size() + nsb * 4 + 5,
            nsb * 8 * 5 + skip.numel())


def k1_call(a, k) -> dict:
    """A K1 call's shape from intra_pred's arguments a, k: its planes,
    lanes, n, the channels it writes and whether it is the race."""
    above = a[0]
    planes = len(above) if isinstance(above, (tuple, list)) else 1
    first = above[0] if planes > 1 else above
    race = k.get("src") is not None
    full = a[5] if len(a) > 5 else k.get("full", True)
    chans = a[7] if len(a) > 7 else k.get("channels")
    nch = 13 if race else len(chans) if chans is not None else (
        61 if full else 7)
    return dict(planes=planes, lanes=first.shape[0], n=a[4], nch=nch,
                race=race)


K1_OPS = 10  # a predicted sample: position, shift, taps, blend and round
SAD_DELTA_OPS = 3  # a race sample and delta: subtract, absolute, accumulate


def _intra_work(a, k):
    """K1's (bytes, operations): the edges and availability flags read,
    the channels it writes of every lane and plane written (~K1_OPS a
    sample); the race also reads the source block and allow_z1, predicts
    the 56 directional variants and the 5 others and sums the SADs, and
    writes the 13-candidate stack and the 8 picks a lane."""
    c = k1_call(a, k)
    B, nn = c["lanes"], c["n"] ** 2
    edges = c["planes"] * B * (2 * c["n"] + 1) * 8 + 2 * B
    out = c["planes"] * B * c["nch"] * nn
    if c["race"]:
        return (edges + B + B * nn * 4 + out * 4 + B * 8 * 4,
                B * nn * (61 * K1_OPS + 56 * SAD_DELTA_OPS))
    return edges + out * 4, out * K1_OPS


def _inv_work(a, k):
    """K3's (bytes, operations): the coefficients and per-block types read
    once (a broadcast once), the output written, the prediction read where
    the reconstruction is fused; ~4 log2(n) a sample."""
    import torch

    coeffs, tx = a[0], a[1]
    nb = coeffs.numel() // (coeffs.shape[-1] * coeffs.shape[-2])
    hh, ww = (64, 64) if k.get("tx64") else coeffs.shape[-2:]
    out = nb * hh * ww
    pred = k.get("pred")
    return (_unique_bytes(coeffs) + (_unique_bytes(tx) if torch.is_tensor(tx)
                                     else 0)
            + out * 4 * (2 if pred is not None else 1),
            out * 4 * ww.bit_length())


# (bytes, operations) of one call of each kernel from its arguments: each
# input read once, each output written once; operations are fp32 FLOPs
# (K2) or integer operations (the rest), counted per sample
WORK = {
    "intra_pred": _intra_work,
    # K2: the levels written unless the call is sums-only (levels=False)
    "fwd_txq": lambda a, k: _fwd_work(a, k, k.get("levels", True)),
    "fwd_txq_thin": lambda a, k: _fwd_work(a, k, k.get("levels", True)),
    "mc_pred": _mc_work,
    "mc_pred_uv": _mc_work,
    "me_fullpel": _me_work,
    "me_fullpel_frame": _me_work,
    "cdef_decide": _decide_work,
    "fwd_rd_float": lambda a, k: _fwd_work(a, k, False, nnz=True),
    "inv_txfm": _inv_work,
    "deblock": lambda a, k: _deblock_pass_work(a),
    # K5: ~14 a sample (bins and weighted squares)
    "cdef_dir": lambda a, k: (a[0].numel() * 4 + a[0].numel() // 64 * 8,
                              a[0].numel() * 14),
    "cdef_filter": _cdef_filter_work,
    # K7: ~30 a sample and direction
    "wiener_solve": lambda a, k: (sum(d.numel() for d in a[0]) * 8 + 84,
                                  sum(d.numel() for d in a[0]) * 2 * 30),
    "wiener_lr": _wiener_lr_work,
    "wiener_lr_frame": _wiener_frame_work,
    "wiener_lr_frame_32": _wiener_frame_work,
    "cfl": _cfl_work,
    "cfl_decide": _cfl_decide_work,
}


# K1's calls by mode: the fine-direction race ("intra_pred", the key
# pass's luma leaves), a channel list on one plane ("intra_pred_list")
# and on U and V at once ("intra_pred_uv")
K1_MODES = ("intra_pred", "intra_pred_list", "intra_pred_uv")
# K3's calls kept besides the largest ("inv_txfm"), one of each mode: the
# fused reconstruction, the 64x64 transform of a 32x32 corner, a tx type
# a block
K3_MODES = ("inv_txfm_pred", "inv_txfm_tx64", "inv_txfm_types")


def k1_mode(a, k) -> str:
    c = k1_call(a, k)
    return ("intra_pred" if c["race"] else
            "intra_pred_uv" if c["planes"] == 2 else "intra_pred_list")


def k3_modes(a, k) -> list:
    import torch

    return ([] if k.get("pred") is None or k.get("tx64")
            else ["inv_txfm_pred"]) + (["inv_txfm_tx64"] if k.get("tx64")
                                       else []) + (
        ["inv_txfm_types"] if torch.is_tensor(a[1]) else [])


# the kernels Capture(shapes=True) keys by shape, and the shapes the
# speed-3 pass adds (phase 12): K1's race at n = 8 (the 8x8 luma leaf) and
# its U and V list at n = 4 (the leaf's chroma), K2 and K3 over the 8x8
# luma leaf's five tx types (a lane's blocks (5, 8, 8)) and the 4x4 uv
# race (two planes of seven candidates, (2, 7, 4, 4)), K11 on 8x8 luma
SHAPED = K1_MODES + ("fwd_txq", "inv_txfm", "cfl")
SPEED3_SHAPES = ("intra_pred_n8_race", "intra_pred_n4_uv",
                 "fwd_txq_n8_5", "fwd_txq_n4_2x7", "inv_txfm_n8_5",
                 "inv_txfm_n4_2x7", "cfl_n8")


def shape_key(key: str, a, k) -> str:
    """key with the call's shape: n and K1's mode, or the blocks a lane
    holds (the dimensions between the lanes and the n x n block)."""
    if key in K1_MODES:
        mode = {"intra_pred": "race", "intra_pred_list": "list",
                "intra_pred_uv": "uv"}[key]
        return f"intra_pred_n{a[4]}_{mode}"
    lane = "x".join(str(d) for d in a[0].shape[1:-2])
    return f"{key}_n{a[0].shape[-1]}" + (f"_{lane}" if lane else "")


def bound_ms(nbytes, ops) -> float:
    return max(nbytes / PEAK_BYTES, ops / PEAK_FP32) * 1e3


def _k4_reads(h: int, w: int, s_along: int, s_across: int, grid) -> tuple:
    """Boolean masks over a pass's (along, across) mi grid of the entries
    K4 reads over an (h, w) view (csrc/deblock.cu): the transform sizes
    and skip flags of both sides of each edge, and the block positions of
    its current side."""
    import numpy as np

    along = (np.arange(0, h, 4) << s_along) >> 2
    ex = np.arange(1, w // 4) * 4
    cur, prev = (ex << s_across) >> 2, ((ex - 1) << s_across) >> 2
    tx = np.zeros(grid, bool)
    bp = np.zeros(grid, bool)
    tx[np.ix_(along, cur)] = tx[np.ix_(along, prev)] = True
    bp[np.ix_(along, cur)] = True
    return tx, bp


def _deblock_pass_work(a) -> tuple:
    """K4's (bytes, operations) on deblock_pass's arguments `a`: each
    sample read and written once as int32, the map entries it reads (4
    bytes a transform size or block position, 1 a skip flag), ~100
    operations a line and edge."""
    img, tx = a[0], a[5]
    txm, bpm = _k4_reads(*img.shape, a[8], a[9], tuple(tx.shape))
    return (img.numel() * 8 + int(txm.sum()) * 5 + int(bpm.sum()) * 4,
            img.numel() * 100 / 4)


# functions whose every call Capture keeps, for check_every: K9, K15, K7,
# K6 and K11's two modes; of RELAUNCH only the inputs
EVERY_CALL = ("mc_block_batch", "decide", "wiener_solve", "cdef_filter",
              "cfl", "cfl_decide")
RELAUNCH = ("mc_block_batch", "cdef_filter", "cfl", "cfl_decide")
# K11's modes read views of the leaf's candidate stacks (K1's DC
# prediction, K2's levels, K3's inverse, the DC SSE and rates): their
# kept calls hold copies of the views (_compact), not the stacks, which
# would stay allocated through the timed encodes
COMPACT = ("cfl", "cfl_decide")
# kernels whose ptxas report must show no stack frame and no spills
NO_STACK = ("intra_pred", "inv_txfm", "mc_pred", "wiener_solve",
            "cdef_decide")


def _clone(v):
    """A copy of v with its broadcast (zero-stride) dimensions kept, so
    that a kept call reads its inputs as the pass's did."""
    import torch

    if isinstance(v, (list, tuple)):
        return type(v)(_clone(x) for x in v)
    if not torch.is_tensor(v):
        return v
    one = tuple(slice(0, 1) if st == 0 else slice(None) for st in v.stride())
    return v[one].clone().expand(v.shape)


def _compact(v):
    """v, or a copy of it (_clone) where v is a tensor whose storage holds
    more than its own elements (a view of a larger tensor)."""
    import math

    if not hasattr(v, "untyped_storage"):
        return v
    own = math.prod(n for n, st in zip(v.shape, v.stride()) if st != 0)
    return _clone(v) if v.untyped_storage().nbytes() > own * v.element_size() \
        else v


class Capture:
    """Wraps the kernels' public functions during the main path, keeps the
    inputs of each kernel's largest call (cloned) and sums the bound of
    every call by stage (the wavefront pass, the band maps, the filter
    chain): the least time the card could take for the stage's kernel
    work.  For the functions named in `keep`, also every call's
    (arguments, keywords, result) in `every[name]`, for the parity of
    each call against the plain version on the same card tensors (K9,
    K15 and K7 always: EVERY_CALL); ncalls["cdef_decide_plain"] counts
    the plain decision's calls.  With
    shapes, K1, K2, K3 and K11 are keyed by their call's shape as well
    (shape_key), so that each shape keeps its own largest call; ncalls
    counts the calls under each key."""

    def __init__(self, keep=(), shapes: bool = False):
        from collections import Counter

        from rav1e_tpu_torch.models import device_pipeline, wavefront
        from rav1e_tpu_torch.ops import (cdef, deblock, filter_chain, intra,
                                         lrf, mc, transforms)

        self.calls = {}
        self.ncalls = Counter()
        self.shapes = shapes
        self.bounds = {}
        self.every = {name: [] for name in keep + EVERY_CALL}
        self.kept_bytes = Counter()  # storage held by COMPACT's kept calls
        self._later = []  # (stage, work, a, k) of EVERY_CALL's calls
        # the plain decision must not run while a card is present
        orig_plain = cdef.decide_plain

        def plain(*a, **k):
            self.ncalls["cdef_decide_plain"] += 1
            return orig_plain(*a, **k)

        cdef.decide_plain = plain
        self._undo = [(cdef, "decide_plain", orig_plain)]
        self.stage = "wavefront_pass"
        for mod, name, stage in (
                (device_pipeline, "launch_band_rd_maps", "band_maps"),
                (filter_chain, "launch_filter_chain", "filter_chain"),
                # the host filter path (speed <= 5)
                (cdef, "cdef_search_apply_device", "cdef_search"),
                (cdef, "cdef_frame_device", "cdef_search"),
                (lrf, "wiener_filter_frame_device", "lr_trial"),
                # the host inter path's ME maps (K10)
                (device_pipeline, "frame_me_map", "me_maps"),
                # the host walk's RD maps above 8 bits (K1, K2)
                (device_pipeline, "frame_rd_maps", "rd_maps"),
                # the inter pass's phase A (K10, K9, K2 with thinning, K3)
                (wavefront.WavefrontPass, "_inter_phase", "inter_phase_a")):
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
                (lrf, "wiener_filter_frame",
                 lambda a, k: ("wiener_lr_frame" if a[3] == 64
                               else "wiener_lr_frame_32"),
                 lambda a, k: a[4] * a[5]),
                (intra, "cfl", "cfl", lambda a, k: a[1].numel()),
                (intra, "cfl_decide", "cfl_decide",
                 lambda a, k: a[0].numel()),
                (intra, "intra_pred",
                 lambda a, k: {"band_maps": "band_intra_pred",
                               "rd_maps": "frame_rd_maps_intra_pred"}.get(
                                   self.stage, k1_mode(a, k)),
                 lambda a, k: _intra_work(a, k)[0]),
                (transforms, "fwd_txq",
                 lambda a, k: ("fwd_txq" if k.get("thr") is None
                               else "fwd_txq_thin"),
                 lambda a, k: a[0].numel()),
                (mc, "mc_block_batch",
                 lambda a, k: ("mc_pred_uv" if isinstance(a[0], tuple)
                               or a[8] else "mc_pred"),
                 lambda a, k: a[4].numel() * a[6] * a[7]),
                (device_pipeline, "me_fullpel",
                 lambda a, k: k.get("count", "me_fullpel"),
                 lambda a, k: a[0].numel()),
                (cdef, "decide", "cdef_decide", lambda a, k: a[0].numel()),
                (transforms, "fwd_rd_float", "fwd_rd_float",
                 lambda a, k: a[0].numel()),
                (transforms, "inv_txfm", "inv_txfm",
                 lambda a, k: _inv_work(a, k)[0]),
                (deblock, "deblock_pass", "deblock",
                 lambda a, k: a[0].numel())):
            self._wrap(mod, name, key, size)

    def _stage(self, mod, name, stage):
        orig = getattr(mod, name)

        def run(*a, **k):
            self.stage = stage
            try:
                return self._keep(name, orig, a, k)
            finally:
                self.stage = "wavefront_pass"

        setattr(mod, name, run)
        self._undo.append((mod, name, orig))

    def _wrap(self, mod, name, key, size):
        import torch

        orig = getattr(mod, name)
        clone = _clone

        def spy(*a, **k):
            n = size(a, k)
            kk_ = key(a, k) if callable(key) else key
            work = WORK[kk_ if kk_ in WORK else name]
            if name in EVERY_CALL:
                # counted in restore(), outside the timed stages: K9's
                # count reads its lanes back from the card
                self._later.append((self.stage, work, a, k))
                b = 0.0
            else:
                b = bound_ms(*work(a, k))
            if self.shapes and kk_ in SHAPED:
                kk_ = shape_key(kk_, a, k)
            self.ncalls[kk_] += 1
            self.bounds[self.stage] = self.bounds.get(self.stage, 0.0) + b
            keys = [kk_]
            if name == "fwd_txq" and k.get("levels") is False:
                keys.append("fwd_txq_sums")  # K2's sums-only calls
            if name == "inv_txfm":
                keys += k3_modes(a, k)
            for kk_ in keys:
                if kk_ not in self.calls or n > self.calls[kk_][0]:
                    self.calls[kk_] = (n, tuple(clone(v) for v in a),
                                       {kk: clone(v) for kk, v in k.items()})
            return self._keep(name, orig, a, k)

        setattr(mod, name, spy)
        self._undo.append((mod, name, orig))

    def _keep(self, name, orig, a, k):
        if name in COMPACT:
            kept = tuple(_compact(v) for v in a)
        out = orig(*a, **k)
        if name in self.every:
            # K9's outputs (~70 MB a race) are not held: holding them would
            # keep the allocator from reusing their memory inside the timed
            # stages; check_every launches the kernel again on the inputs
            self.every[name].append(
                (kept if name in COMPACT else a, k,
                 None if name in RELAUNCH else out))
            if name in COMPACT:
                self.kept_bytes[name] += sum(
                    v.untyped_storage().nbytes() for v in kept
                    if hasattr(v, "untyped_storage"))
        return out

    def restore(self):
        for mod, name, orig in self._undo:
            setattr(mod, name, orig)
        for stage, work, a, k in self._later:
            self.bounds[stage] += bound_ms(*work(a, k))
        self._later = []


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
              library_ms=None, **more):
        """`more`: further measured numbers of the kernel (K2: device_ms,
        library_device_ms), printed on its line and kept in its entry."""
        nbytes, ops = work
        tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
        print(json.dumps({"kernel": name, "max_abs_diff": err, "ms": ms,
                          "plain_ms": plain_ms, "library_ms": library_ms,
                          "launches_per_frame": counts[name]
                          / frames_per_run, "bound_ms": max(tb, to),
                          "bound_by": "bytes" if tb >= to
                          else "operations", **more}))
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name], launches_per_frame=counts[name]
            / frames_per_run, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(tb, to), bound_by="bytes" if tb >= to
            else "operations", library_ms=library_ms, **more))

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


def fwd_in_place(name, resid, Fv, FhT, tidx, qdc, qac, thr) -> None:
    """Raise unless K2's wrapper reads every input of this call in place
    (block_layout): one launch, no copy of a broadcast or strided input."""
    from rav1e_tpu_torch.ops import transforms as tt

    held = []
    tt._plan((resid, Fv, FhT, tidx, qdc, qac, thr), resid.shape[:-2],
             resid.shape[-1], Fv.shape[-2], held)
    if held:
        raise RuntimeError(f"{name}: K2's wrapper copies {len(held)} "
                           "input(s) of the path's call")


def fwd_check(name, a, k) -> dict:
    """K2 (integer variant) on one kept call (arguments a, keywords k):
    its full outputs held against the plain version by the tie rule
    (check_fwd_ties); a sums-only call's (levels=False) dist and rate
    equal to the full call's.  Returns its max level difference (err),
    plain_ms, the times of fwd_times, its work (bytes and operations as
    called) and, for a sums-only call, the bound with the levels counted
    (bound_ms_with_levels)."""
    import torch

    from rav1e_tpu_torch.ops import transforms as tt

    resid, Fv, FhT, qdc, qac, shift = a[:6]
    full_k = dict(k, levels=True)
    qd, qa = tt._as_blocks(qdc, resid), tt._as_blocks(qac, resid)
    ti = (tt._as_blocks(k["tidx"], resid) if k.get("tidx") is not None
          else torch.zeros(resid.shape[:-2], dtype=torch.int32,
                           device=resid.device))
    thr = (None if k.get("thr") is None
           else tt._as_blocks(k["thr"], resid, torch.float32))
    plain = lambda: tt.fwd_txq_plain(resid, Fv, FhT, ti, qd, qa, shift,
                                     k.get("bit_depth", 8), thr)
    fwd_in_place(name, resid, Fv, FhT, k.get("tidx"), qdc, qac, k.get("thr"))
    full = tt.fwd_txq(*a, **full_k)
    err, _share = check_fwd_ties(full, plain(), a, k, name)
    more = {}
    if k.get("levels") is False:
        got = tt.fwd_txq(*a, **k)
        if got[0] is not None or not (torch.equal(got[2], full[2])
                                      and torch.equal(got[3], full[3])):
            raise RuntimeError(f"{name}: the sums-only call's sums differ "
                               "from the full call's")
        more["bound_ms_with_levels"] = bound_ms(*WORK["fwd_txq"](a, full_k))
    return dict(err=err, plain_ms=cuda_ms(plain), work=WORK["fwd_txq"](a, k),
                full=full, more=more,
                **fwd_times(lambda: tt.fwd_txq(*a, **k), a))


def fwd_entry(entry, name, replaces, a, k) -> dict:
    """fwd_check on one kept call, written as the kernel entry `name`."""
    r = fwd_check(name, a, k)
    entry(name, "rav1e_tpu_torch/csrc/fwd_txq.cu", replaces, r["err"],
          r["ms"], r["plain_ms"], r["work"], library_ms=r["library_ms"],
          device_ms=r["device_ms"],
          library_device_ms=r["library_device_ms"], **r["more"])
    return r


def fwd_sums_only(calls, card: str) -> None:
    """The largest sums-only K2 call of the run (the 13-candidate mode
    race), checked and timed as fwd_check, on a line of its own (it is
    no kernel entry: its launches count under fwd_txq)."""
    if "fwd_txq_sums" not in calls:
        raise RuntimeError("no sums-only fwd_txq call on the path")
    _, a, k = calls["fwd_txq_sums"]
    r = fwd_check("fwd_txq_sums", a, k)
    print(json.dumps({"fwd_txq_sums_only": {
        "shape": list(a[0].shape), "max_abs_diff": r["err"], "ms": r["ms"],
        "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": bound_ms(*r["work"]), **r["more"],
        "library_ms": r["library_ms"],
        "library_device_ms": r["library_device_ms"], "card": card}}))


def k1_check(name, a, k, reps: int = 20, plain_reps: int = 20,
             timed: bool = True) -> dict:
    """K1 on one kept call (intra_pred's arguments a, k): identical to
    its plain version on the same card tensors; with timed, its eager ms,
    device_ms (graph_ms) and the plain version's ms."""
    from rav1e_tpu_torch.ops import intra

    call = lambda: intra.intra_pred(*a, **k)
    plain = lambda: intra.intra_pred_plain(*a, **k)
    r = dict(err=_same(call(), plain(), name), work=WORK["intra_pred"](a, k))
    if timed:
        r.update(ms=cuda_ms(call, reps), plain_ms=cuda_ms(plain, plain_reps),
                 device_ms=graph_ms(call, reps), host_ms=host_ms(call, reps))
    return r


def k3_check(name, a, k, timed: bool = True) -> dict:
    """K3 on one kept call (inv_txfm's arguments a, k): identical to its
    plain route (inv_txfm_types_plain: per type, the padding of tx64 and
    the clamp of pred) on the same card tensors; with timed, its eager
    ms, device_ms and the plain route's ms."""
    from rav1e_tpu_torch.ops import transforms as tt

    call = lambda: tt.inv_txfm(*a, **k)
    plain = lambda: tt.inv_txfm_types_plain(*a, **k)
    r = dict(err=_same(call(), plain(), name), work=WORK["inv_txfm"](a, k))
    if timed:
        r.update(ms=cuda_ms(call), plain_ms=cuda_ms(plain),
                 device_ms=graph_ms(call), host_ms=host_ms(call))
    return r


def check_modes(calls, path: str, card: str, timed: bool = False,
                keys=K1_MODES[1:] + K3_MODES) -> None:
    """K1's list and U+V calls and K3's fused, tx64 and per-type calls:
    the largest kept call of each mode on this path held against its
    plain version (identical), on a line of its own (with timed, also
    its ms, device_ms and bound; the launches count under the kernel's
    entries)."""
    out = {}
    for key in keys:
        if key not in calls:
            continue
        _, a, k = calls[key]
        chk = k1_check if key.startswith("intra_pred") else k3_check
        r = chk(key, a, k, timed=timed)
        first = a[0][0] if isinstance(a[0], (tuple, list)) else a[0]
        out[key] = {"shape": list(first.shape), "max_abs_diff": r["err"],
                    "bound_ms": bound_ms(*r["work"]),
                    **{m: r[m] for m in ("ms", "device_ms", "host_ms",
                                         "plain_ms") if m in r}}
    print(json.dumps({"k1_k3_modes": out, "path": path, "card": card}))


def check_decide_launches(counts, cap, frames: int, path: str) -> None:
    """K15 must have launched once for each of the path's frames (each
    runs CDEF), and the plain decision never."""
    if counts["cdef_decide"] != frames or cap.ncalls["cdef_decide_plain"]:
        raise RuntimeError(
            f"cdef_decide launched {counts['cdef_decide']} times for "
            f"{frames} frames on {path}, the plain decision ran "
            f"{cap.ncalls['cdef_decide_plain']} times")


def check_every(cap, path: str, card: str) -> dict:
    """Every call of K9, K15, K7, K6 and K11 (fit and decide) kept on
    this path (Capture's EVERY_CALL) held against its plain version on the
    same card tensors (K9, K6 and K11 launched again on their kept
    inputs): identical, or the path fails.  Prints and returns the calls
    and the largest difference of each."""
    from rav1e_tpu_torch.ops import cdef, intra, lrf, mc

    plain = {"mc_block_batch": (mc.mc_block_batch, mc.mc_block_batch_plain),
             "decide": (cdef.decide, cdef.decide_plain),
             "wiener_solve": (lrf.wiener_solve, lrf.wiener_solve_plain),
             "cdef_filter": (cdef.cdef_filter, cdef.cdef_filter_plain),
             "cfl": (intra.cfl, intra.cfl_plain),
             "cfl_decide": (intra.cfl_decide, intra.cfl_decide_plain)}
    out = {}
    for name, (kern, fn) in plain.items():
        calls = cap.every.get(name, [])
        if name in BATCHED:
            err = _same_batched(calls, kern, fn, f"{name} ({path})")
        else:
            err = max((_same(kern(*a, **k) if got is None else got,
                             fn(*a, **k), f"{name} ({path})")
                       for a, k, got in calls), default=0)
        out[name] = {"calls": len(calls), "max_abs_diff": err}
        if name in COMPACT:
            out[name]["kept_bytes"] = cap.kept_bytes[name]
    print(json.dumps({"every_call": out, "path": path, "card": card}))
    return out


# K11's modes run thousands of small calls a frame at speeds 5 and 3; their
# plain versions treat every block on its own, so check_every runs each
# plain version once over all kept calls of a shape (and of one pass's
# rate tables) stacked along the blocks
BATCHED = ("cfl", "cfl_decide")


def _stacks(args):
    """Groups of calls' argument tuples whose tensors stack along the
    blocks (one shape; non-tensor arguments and tuples of tables of one
    storage in common): [(the group's argument tuples, the arguments
    stacked)]."""
    import torch

    def key(a):
        return tuple(
            (tuple(v.shape[1:]) if v.shape[0] == a[0].shape[0]
             else ("shared", v.data_ptr())) if torch.is_tensor(v) else
            tuple(t.data_ptr() for t in v) if isinstance(v, tuple) else v
            for v in a)

    groups = {}
    for a in args:
        groups.setdefault(key(a), []).append(a)
    out = []
    for group in groups.values():
        first = group[0]
        out.append((group, [
            torch.cat([a[i] for a in group])
            if torch.is_tensor(v) and v.shape[0] == first[0].shape[0] else v
            for i, v in enumerate(first)]))
    return out


def _same_batched(calls, kern, fn, name) -> int:
    """The kernel launched again on each kept call, the plain version once
    over each group of calls that stack (_stacks), and the stacked
    results compared (_same)."""
    import torch

    if any(k for _a, k, _got in calls):
        raise ValueError(f"{name}: keyword arguments are not batched")
    err = 0
    for group, cat in _stacks([a for a, _k, _got in calls]):
        got = [kern(*a) for a in group]
        got = tuple(torch.cat([g[j] for g in got]) for j in range(len(got[0])))
        err = max(err, _same(got, fn(*cat), name))
    return err


def check_kernels(calls, counts, frames_per_run):
    """Parity, times and bounds of each kernel on its captured inputs.
    Returns the kernels JSON list."""
    import torch

    from rav1e_tpu_torch.ops import deblock, transforms as tt

    out = []
    entry = make_entry(out, counts, frames_per_run)

    # K1 intra_pred: the key pass's largest race (the 32x32 leaves)
    _, a, k = calls["intra_pred"]
    r = k1_check("intra_pred", a, k)
    entry("intra_pred", "rav1e_tpu_torch/csrc/intra_pred.cu",
          "rav1e_tpu/ops/intra_jax.py:305", r["err"], r["ms"], r["plain_ms"],
          r["work"], device_ms=r["device_ms"], host_ms=r["host_ms"])

    # K2 fwd_txq, integer variant (the wavefront's races)
    _, a, k = calls["fwd_txq"]
    r = fwd_entry(entry, "fwd_txq", "rav1e_tpu/ops/transforms_jax.py:465",
                  a, k)
    # the part of its device time that does not grow with the blocks: the
    # same launch over the call's first block alone
    nd = a[0].dim() - 2
    first = lambda v: (v.expand(a[0].shape[:nd])[(slice(0, 1),) * nd]
                       if torch.is_tensor(v) else v)
    a1 = ((a[0][(slice(0, 1),) * nd],) + tuple(a[1:3])
          + (first(a[3]), first(a[4])) + tuple(a[5:]))
    k1 = {key: first(v) if key in ("tidx", "thr") else v
          for key, v in k.items()}
    print(json.dumps({"fwd_txq_call": {
        "shape": list(a[0].shape), "device_ms": r["device_ms"],
        "first_block_device_ms": graph_ms(lambda: tt.fwd_txq(*a1, **k1))}}))

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

    # K3 inv_txfm: the path's largest call (the 64x64 root's luma)
    _, a, k = calls["inv_txfm"]
    r = k3_check("inv_txfm", a, k)
    entry("inv_txfm", "rav1e_tpu_torch/csrc/inv_txfm.cu",
          "rav1e_tpu/ops/transforms_jax.py:432", r["err"], r["ms"],
          r["plain_ms"], r["work"], device_ms=r["device_ms"],
          host_ms=r["host_ms"])

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
    r = timed(lambda: deblock.deblock_pass(*a, **k))
    entry("deblock", "rav1e_tpu_torch/csrc/deblock.cu",
          "rav1e_tpu/ops/deblock_jax.py:125", err, r["ms"],
          cuda_ms(lambda: deblock.deblock_pass_plain(
              img, lim, blim, thr, 8, pidx, tx, bp, sk, s_al, s_ac), reps=5),
          WORK["deblock"](a, k), device_ms=r["device_ms"],
          host_ms=r["host_ms"])
    check_filter_kernels(calls, entry)
    return out


def _same(got, ref, name) -> int:
    """max |got - ref| over tensors (or tuples of them); raises unless 0."""
    import torch

    pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
    if any(g.shape != r.shape for g, r in pairs):
        raise RuntimeError(f"{name}: shapes differ from its plain version")
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


def k6_times(line: str, s_a, p_a) -> dict:
    """K6's search call s_a and apply call p_a timed each (ms, device_ms,
    host_ms) beside its bound, printed on a line of its own; returns the
    two calls' sums and their summed work."""
    from rav1e_tpu_torch.ops import cdef

    out, work = {}, []
    for mode, a in (("search", s_a), ("apply", p_a)):
        w_ = WORK["cdef_filter"](a, {})
        work.append(w_)
        out[mode] = dict(timed(lambda: cdef.cdef_filter(*a)),
                         bound_ms=bound_ms(*w_), size=list(a[0].shape),
                         bd=a[12] if len(a) > 12 else 8)
    print(json.dumps({line: out}))
    return dict({k: out["search"][k] + out["apply"][k]
                 for k in ("ms", "device_ms", "host_ms")},
                work=(work[0][0] + work[1][0], work[0][1] + work[1][1]))


def check_filter_kernels(calls, entry):
    """K5-K8 (cdef_dir, cdef_filter, wiener_solve, wiener_lr) and K15
    (cdef_decide) on the main path's largest calls: parity with the plain
    versions, times, bounds (WORK counts the bytes and operations of
    each)."""
    import torch

    from rav1e_tpu_torch.ops import cdef, lrf

    # K5 cdef_dir on the deblocked luma
    _, a, _k = calls["cdef_dir"]
    err = _same(cdef.cdef_dir(*a), cdef.cdef_dir_plain(*a), "cdef_dir")
    r = timed(lambda: cdef.cdef_dir(*a))
    entry("cdef_dir", "rav1e_tpu_torch/csrc/cdef_dir.cu",
          "rav1e_tpu/ops/cdef_jax.py:43", err, r["ms"],
          cuda_ms(lambda: cdef.cdef_dir_plain(*a), reps=5),
          WORK["cdef_dir"](a, {}), device_ms=r["device_ms"],
          host_ms=r["host_ms"])

    # K6 cdef_filter: the search (8 luma + 3 chroma candidates' superblock
    # SSE) and the apply of the chosen pairs, the frame's two launches
    _, s_a, _k = calls["cdef_filter_search"]
    _, p_a, _k = calls["cdef_filter_apply"]
    err = max(_same(cdef.cdef_filter(*s_a), cdef.cdef_filter_plain(*s_a),
                    "cdef_filter (search)"),
              _same(cdef.cdef_filter(*p_a), cdef.cdef_filter_plain(*p_a),
                    "cdef_filter (apply)"))
    r = k6_times("cdef_filter_calls", s_a, p_a)
    entry("cdef_filter", "rav1e_tpu_torch/csrc/cdef_filter.cu",
          "rav1e_tpu/ops/cdef_jax.py:84", err, r["ms"],
          cuda_ms(lambda: cdef.cdef_filter_plain(*s_a), reps=3)
          + cuda_ms(lambda: cdef.cdef_filter_plain(*p_a), reps=3),
          r["work"], device_ms=r["device_ms"], host_ms=r["host_ms"])

    # K7 wiener_solve over the three planes
    _, a, _k = calls["wiener_solve"]
    ds, ss = a
    taps, en = lrf.wiener_solve(ds, ss)
    rt, re = lrf.wiener_solve_plain(ds, ss)
    ties = wiener_ties(ds, ss, taps, rt)
    if not bool((en == re).all()) and not ties:
        raise RuntimeError("wiener_solve en differs from its plain version")
    print(json.dumps({"wiener_solve_ties": ties}))
    r = timed(lambda: lrf.wiener_solve(ds, ss))
    entry("wiener_solve", "rav1e_tpu_torch/csrc/wiener_solve.cu",
          "rav1e_tpu/ops/filter_chain_jax.py:25",
          int((taps - rt).abs().max()), r["ms"],
          cuda_ms(lambda: lrf.wiener_solve_plain(ds, ss), reps=5),
          WORK["wiener_solve"](a, {}), device_ms=r["device_ms"],
          host_ms=r["host_ms"])

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
    r = timed(lambda: lrf.wiener_lr(*a))
    entry("wiener_lr", "rav1e_tpu_torch/csrc/wiener_lr.cu",
          "rav1e_tpu/ops/lrf_jax.py:77", err, r["ms"],
          cuda_ms(lambda: lrf.wiener_lr_plain(*a), reps=5),
          WORK["wiener_lr"](a, {}), device_ms=r["device_ms"],
          host_ms=r["host_ms"])

    # K15 cdef_decide on the path's largest call (every call: check_every);
    # the plain version's device time by the profiler (a graph cannot
    # capture its host-to-device copy)
    _, a, k = calls["cdef_decide"]
    call = lambda: cdef.decide(*a, **k)
    plain = lambda: cdef.decide_plain(*a, **k)
    err = _same(call(), plain(), "cdef_decide")
    r = timed(call)
    entry("cdef_decide", "rav1e_tpu_torch/csrc/cdef_decide.cu",
          "rav1e_tpu/ops/cdef_jax.py:279", err, r["ms"], cuda_ms(plain),
          WORK["cdef_decide"](a, k), device_ms=r["device_ms"],
          host_ms=r["host_ms"], plain_device_ms=profiler_ms(plain),
          plain_host_ms=host_ms(plain), superblocks=int(a[0][0].numel()))


# K9's calls kept on the inter path: the luma candidate race and chroma
K9_KEYS = ("mc_pred", "mc_pred_uv")


def k9_check(key, a, k, timed_: bool = True) -> dict:
    """K9 on one kept call (mc_block_batch's arguments a, k): identical to
    its plain version on the same card tensors; with timed_, its ms,
    device_ms, host_ms and the plain version's ms, beside its bound."""
    from rav1e_tpu_torch.ops import mc

    call = lambda: mc.mc_block_batch(*a, **k)
    plain = lambda: mc.mc_block_batch_plain(*a, **k)
    work = WORK[key](a, k)
    r = dict(err=_same(call(), plain(), key), blocks=int(a[4].numel()),
             w=a[6], h=a[7], work=work, bound_ms=bound_ms(*work))
    if timed_:
        r.update(timed(call), plain_ms=cuda_ms(plain, reps=3))
    return r


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

    # K9: the largest luma race call and the largest chroma call
    k9 = {key: k9_check(key, *calls[key][1:]) for key in K9_KEYS}
    print(json.dumps({"mc_pred_calls": k9}))
    r = k9["mc_pred"]
    entry("mc_pred", "rav1e_tpu_torch/csrc/mc_pred.cu",
          "rav1e_tpu/ops/mc_jax.py:71", max(v["err"] for v in k9.values()),
          r["ms"], r["plain_ms"], r["work"], device_ms=r["device_ms"],
          host_ms=r["host_ms"])

    _, a, k = calls["me_fullpel"]
    err = _same(dp.me_fullpel(*a, **k), dp.me_fullpel_plain(*a, **k),
                "me_fullpel")
    r = timed(lambda: dp.me_fullpel(*a, **k))
    entry("me_fullpel", "rav1e_tpu_torch/csrc/me_fullpel.cu",
          "rav1e_tpu/models/device_pipeline.py:290", err, r["ms"],
          cuda_ms(lambda: dp.me_fullpel_plain(*a, **k), reps=3),
          WORK["me_fullpel"](a, k), device_ms=r["device_ms"],
          host_ms=r["host_ms"])

    _, a, k = calls["fwd_txq_thin"]
    r = fwd_entry(entry, "fwd_txq_thin", "rav1e_tpu/models/wavefront.py:416",
                  a, k)
    got = r["full"]
    thinned = int((tt.fwd_txq(*a[:6])[0].abs() == 1).sum()
                  - (got[0].abs() == 1).sum())
    # where its device time goes: the same launch sums-only (no level
    # stores), then sums-only over one block's residual broadcast to every
    # block (its reads hit in cache, so next to no residual bytes come
    # from memory); the rest is the transforms and the epilogue
    sums = lambda x: tt.fwd_txq(x, *a[1:], **dict(k, levels=False))
    one = a[0][(0,) * (a[0].dim() - 2)].expand_as(a[0])
    print(json.dumps({"fwd_txq_thin_call": {
        "levels_thinned": thinned, "device_ms": r["device_ms"],
        "sums_only_device_ms": graph_ms(lambda: sums(a[0])),
        "one_residual_sums_only_device_ms": graph_ms(lambda: sums(one))}}))
    return out


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


def check_decode(data, recon) -> str:
    """Where libdav1d loads, the stream must decode to the recon (display
    order, every frame and plane)."""
    import numpy as np

    try:
        from rav1e_tpu_torch.utils import dav1d_oracle

        dav1d_oracle.Dav1dDecoder().close()
    except OSError:
        print("dav1d: libdav1d is absent on this machine; checking by "
              "re-derivation instead")
        return "absent"
    dec = dav1d_oracle.decode_stream(data)
    if len(dec) != len(recon):
        raise RuntimeError(f"dav1d decoded {len(dec)} of {len(recon)}")
    for f, (d, r) in enumerate(zip(dec, recon)):
        for p in range(3):
            rp = np.asarray(r[p])
            if not np.array_equal(d[p][: rp.shape[0], : rp.shape[1]], rp):
                raise RuntimeError(f"dav1d decode != recon: frame {f} "
                                   f"plane {p}")
    return "decode == recon, all frames and planes"


def bottom_lr_units(fes) -> list:
    """Per frame, the restoring loop-restoration units of the bottom unit
    row (luma: Wiener or SGR; chroma: where the plane is coded
    RESTORE_WIENER): where a stripe ends at the plane's last row, their
    taps below it take the stripe rule of ROADMAP F7."""
    out = []
    for fe in fes:
        units = {0: fe._lr_params}
        units.update({p: fe._lr_chroma[p] for p in (1, 2)
                      if fe.lr_types[p] == 2})
        row = {}
        for p, u in units.items():
            last = max((ur for ur, _uc in u), default=-1)
            row[f"plane{p}"] = sum(1 for (ur, _uc), v in u.items()
                                   if ur == last and v is not None)
        out.append(row)
    return out


def save_stream(name: str, data, digests: dict, size=None) -> None:
    """With --save-stream DIR: DIR/<name>.ivf and DIR/<name>_recon.json
    (the recon digests), for rav1e_tpu_torch/utils/stream_check.py to
    decode on a machine with libdav1d."""
    from rav1e_tpu_torch.obu.ivf import write_ivf_frame, write_ivf_header

    if "--save-stream" not in sys.argv:
        return
    out = Path(sys.argv[sys.argv.index("--save-stream") + 1])
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"{name}.ivf", "wb") as fh:
        write_ivf_header(fh, *(size or (W, H)), 30, 1, len(data))
        for i, pkt in enumerate(data):
            write_ivf_frame(fh, i, pkt)
    (out / f"{name}_recon.json").write_text(json.dumps(digests))


def rederive_sbs(fes) -> tuple:
    """SB_SAMPLES device superblocks of each wavefront frame re-derived
    from their records onto its pre-filter recon (inter blocks by mc_np
    from LAST's output recon).  Returns (superblocks, those holding inter
    blocks)."""
    import numpy as np

    from rav1e_tpu_torch.utils import recon_check

    rng = np.random.default_rng(0)
    checked = inter_sbs = 0
    for fe in fes:
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
    return checked, int(inter_sbs)


def check_output(data, recon, fes, filter_frames: int):
    """decode == recon where libdav1d loads; SB re-derivation always, and
    the numpy filter chain (deblock_np, cdef_np, lrf_np) over the first
    filter_frames frames.  Returns a summary dict."""
    from rav1e_tpu_torch.utils import recon_check

    summary = {"dav1d": check_decode(data, recon)}
    checked, inter_sbs = rederive_sbs(fes)
    # the first filter_frames frames, or with inter frames the first
    # filter_frames of those
    inter = [f for f, fe in enumerate(fes) if fe._chk_wf.has_mv]
    for f in (inter or list(range(len(fes))))[:filter_frames]:
        fe = fes[f]
        if not recon_check.filters_match(fe, fe._chk_prefilter, recon[f]):
            raise RuntimeError(f"frame {f}: the numpy filter chain over the "
                               "pre-filter frame differs from the output")
    summary["sbs_rederived"] = checked
    summary["sbs_rederived_with_inter_blocks"] = inter_sbs
    summary["filter_chain_np_frames"] = filter_frames
    summary["cdef_per_sb"] = sum(fe.cdef_sb is not None for fe in fes)
    summary["lr_units_restored"] = sum(
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
        for owner, name, orig in undo:
            setattr(owner, name, orig)
        cap.restore()
    t_first = time.perf_counter() - t0
    counts = dict(kernels.COUNTS)
    types = encode.frame_types
    print(json.dumps({"mixed_path_launches": counts,
                      "first_encode_s": t_first, "frame_types": types,
                      "serialised_s": dict(secs), "card": card}))
    # every counter but the speed-5 path's own (phase 9), the host inter
    # path's (phase 10), frame_rd_maps (phase 11) and the tile route's
    # (phase 13)
    missing = [k for k, v in counts.items()
               if v == 0 and k not in ("cfl", "cfl_decide", "wiener_lr_frame",
                                       "me_fullpel_frame", "frame_rd_maps",
                                       "wavefront_tiles", "wiener_lr_decide")
               + ANALYSIS_KERNELS]
    if missing:
        raise RuntimeError(f"kernels not launched on the mixed path: "
                           f"{missing}")
    check_decide_launches(counts, cap, MIXED_FRAMES, "the mixed GOP")
    # K9 a level of an inter frame: the luma race and U + V (3 levels)
    if counts["mc_pred"] != 6 * (MIXED_FRAMES - 1):
        raise RuntimeError(f"{counts['mc_pred']} K9 launches for "
                           f"{MIXED_FRAMES - 1} inter frames, not 6 each")
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
    check_modes(cap.calls, "mixed_gop", card)
    t1 = time.perf_counter()
    summary = check_output(data, recon, fes, INTER_FILTER_FRAMES)
    print(json.dumps({"mixed_output": summary, "bytes": sum(map(len, data)),
                      "check_s": time.perf_counter() - t1}))
    t2 = time.perf_counter()
    data2, _, _ = encode(frames[:MIXED_TIMED], check=False, mixed=True)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t2
    if data2 != data[:MIXED_TIMED]:
        raise RuntimeError("the second mixed-GOP encode wrote other bytes")
    print(json.dumps({"mixed_encode": {
        "frames": MIXED_TIMED, "size": f"{W}x{H}", "seconds": t_enc,
        "fps": MIXED_TIMED / t_enc, "stages_s": encode.stages,
        "card": card}}))
    check_every(cap, "mixed_gop", card)
    return results


# speed 5 on the host filter path: launched, and not launched (the host
# deblocks; the frame taps are the host's tap solve, K8 only filters)
SPEED5_LAUNCHED = ("intra_pred", "fwd_txq", "inv_txfm", "cdef_dir",
                   "cdef_filter", "wiener_lr_frame", "cfl", "cfl_decide")
SPEED5_IDLE = ("deblock", "wiener_solve")
# the default configuration: the key frame and the first ALTREF take the
# passes and the chain (K1-K10), the host frames K10 through frame_me_map,
# K5 and K6 after the host deblock and K8 in frame mode for the LR trial
DEFAULT_LAUNCHED = ("intra_pred", "fwd_txq", "inv_txfm", "deblock",
                    "cdef_dir", "cdef_filter", "wiener_solve", "wiener_lr",
                    "mc_pred", "me_fullpel", "fwd_txq_thin",
                    "me_fullpel_frame", "wiener_lr_frame")


def check_speed5_kernels(calls, counts, frames_per_run):
    """K11 cfl and K8 in frame mode (stripes 64 and 32) on the speed-5
    path's largest calls: identical to their plain versions, timed beside
    their bounds.  No single PyTorch call computes either (library_ms
    null).  Returns the kernels JSON list."""
    from rav1e_tpu_torch.ops import intra, lrf

    out = []
    entry = make_entry(out, counts, frames_per_run)
    _, a, _k = calls["cfl"]
    err = _same(intra.cfl(*a), intra.cfl_plain(*a), "cfl")
    print(json.dumps({"cfl_call": {"blocks": int(a[0].shape[0]),
                                   "n": int(a[0].shape[-1])}}))
    r = timed(lambda: intra.cfl(*a))
    entry("cfl", "rav1e_tpu_torch/csrc/cfl.cu",
          "rav1e_tpu/ops/intra_jax.py:317", err, r["ms"],
          cuda_ms(lambda: intra.cfl_plain(*a)), WORK["cfl"](a, {}),
          device_ms=r["device_ms"], host_ms=r["host_ms"])
    # K11's decide mode (row 14c) on the path's largest call
    _, a, _k = calls["cfl_decide"]
    err = _same(intra.cfl_decide(*a), intra.cfl_decide_plain(*a),
                "cfl_decide")
    r = timed(lambda: intra.cfl_decide(*a))
    entry("cfl_decide", "rav1e_tpu_torch/csrc/cfl.cu",
          "rav1e_tpu/models/wavefront.py:733", err, r["ms"],
          cuda_ms(lambda: intra.cfl_decide_plain(*a)),
          WORK["cfl_decide"](a, {}), device_ms=r["device_ms"],
          host_ms=r["host_ms"], blocks=int(a[0].shape[0]),
          n=int(a[0].shape[-1]) * 2)
    errs = {}
    for key in ("wiener_lr_frame", "wiener_lr_frame_32"):
        _, a, _k = calls[key]
        errs[a[3]] = _same(lrf.wiener_filter_frame(*a), _wiener_plain(a),
                           f"wiener_lr frame mode, stripe {a[3]}")
    print(json.dumps({"wiener_lr_frame_parity": errs}))
    _, a, _k = calls["wiener_lr_frame"]
    entry("wiener_lr_frame", "rav1e_tpu_torch/csrc/wiener_lr.cu",
          "rav1e_tpu/ops/lrf_jax.py:43", max(errs.values()),
          cuda_ms(lambda: lrf.wiener_filter_frame(*a)),
          cuda_ms(lambda: _wiener_plain(a), reps=5),
          WORK["wiener_lr_frame"](a, {}))
    return out


def _wiener_plain(a):
    """wiener_filter_plain on the arguments of a wiener_filter_frame call
    (cd, db, taps, stripe, hh, ww[, bd])."""
    from rav1e_tpu_torch.ops import lrf

    cd, db, taps, stripe, hh, ww = a[:6]
    return lrf.wiener_filter_plain(cd, db, taps[0], taps[1], stripe, hh, ww,
                                   *a[6:])


def _search_apply_plain(y, u, v, sy, su, sv, skip, sb_lam, damping):
    """ops/cdef.py search_apply through the plain versions of K5, K6 and
    K15."""
    from rav1e_tpu_torch.ops import cdef

    h, w = y.shape
    dirs, var = cdef.cdef_dir_plain(y)
    act = cdef.active_blocks(skip, h, w)
    sse = cdef.cdef_filter_plain(y, u, v, sy, su, sv, dirs, var, act,
                                 damping, cdef.SEARCH)
    sel = cdef.decide_plain(sse, skip, sb_lam, h, w)
    return sel + cdef.cdef_filter_plain(y, u, v, sy, su, sv, dirs, var, act,
                                        damping, cdef.APPLY, sel[2])


def time_cdef_route(calls) -> dict:
    """The CDEF search outside the chain (cdef_search_apply_device's
    device work: K5, K6 search, the decision, K6 apply) timed on the
    speed-5 path's captured frame, beside the plain versions and the sum
    of the four calls' bounds."""
    from rav1e_tpu_torch.ops import cdef

    _, d, _k = calls["cdef_dir"]
    _, s_a, _k = calls["cdef_filter_search"]
    _, p_a, _k = calls["cdef_filter_apply"]
    _, c_a, _k = calls["cdef_decide"]
    y, u, v, sy, su, sv = s_a[:6]
    skip, lam, damping = c_a[1], c_a[2], s_a[9]
    got = cdef.search_apply(y, u, v, sy, su, sv, skip, lam, damping)
    ref = _search_apply_plain(y, u, v, sy, su, sv, skip, lam, damping)
    err = _same(tuple(got[2:]), tuple(ref[2:]), "cdef search_apply")
    works = [WORK["cdef_dir"](d, {}), WORK["cdef_filter"](s_a, {}),
             WORK["cdef_decide"](c_a, {}), WORK["cdef_filter"](p_a, {})]
    return {"ms": cuda_ms(lambda: cdef.search_apply(
                y, u, v, sy, su, sv, skip, lam, damping)),
            "plain_ms": cuda_ms(lambda: _search_apply_plain(
                y, u, v, sy, su, sv, skip, lam, damping), reps=2),
            "bound_ms": sum(bound_ms(*w_) for w_ in works),
            "max_abs_err": err, "size": list(y.shape)}


def time_cdef_frame(calls) -> dict:
    """cdef_frame_device's device work (K5, then K6 in apply mode with
    the fixed strengths) on the small route's captured frame: identical
    to the plain versions, timed beside them and the bound."""
    from rav1e_tpu_torch.ops import cdef

    _, d, _k = calls["cdef_dir"]
    _, p_a, _k = calls["cdef_filter_apply"]
    err = max(_same(cdef.cdef_dir(*d), cdef.cdef_dir_plain(*d), "cdef_dir"),
              _same(cdef.cdef_filter(*p_a), cdef.cdef_filter_plain(*p_a),
                    "cdef_filter (fixed strengths)"))
    return {"ms": cuda_ms(lambda: (cdef.cdef_dir(*d), cdef.cdef_filter(*p_a))),
            "plain_ms": cuda_ms(lambda: (cdef.cdef_dir_plain(*d),
                                         cdef.cdef_filter_plain(*p_a)),
                                reps=5),
            "bound_ms": bound_ms(*WORK["cdef_dir"](d, {}))
            + bound_ms(*WORK["cdef_filter"](p_a, {})),
            "max_abs_err": err, "size": list(p_a[0].shape)}


def rederive_cfl(fes, limit: int = 64) -> dict:
    """Re-derive every sampled device superblock that holds a CFL block
    (uv mode 13 on an intra block), up to `limit`: the CFL chroma is the
    DC prediction with the coded alpha on the block's final luma AC."""
    import numpy as np

    from rav1e_tpu_torch.utils import recon_check

    sbs = blocks = 0
    for fe in fes:
        wf = fe._chk_wf
        for sr, sc in np.argwhere(wf.geom.device_sb):
            recs = wf.sb_records(int(sr), int(sc))
            n = sum(b[4] != 13 and b[12] == 13 for b in recs)
            if not n or sbs >= limit:
                continue
            if not recon_check.rederive_sb(wf, fe._chk_prefilter, int(sr),
                                           int(sc), fe.dc_q, fe.ac_q):
                raise RuntimeError(f"CFL SB ({sr}, {sc}) does not re-derive")
            sbs += 1
            blocks += n
    return {"cfl_sbs_rederived": sbs, "cfl_blocks_in_them": int(blocks)}


def lr_units(fes) -> dict:
    """The luma loop-restoration units chosen by kind: Wiener with the
    frame's taps, Wiener with the unit's own taps, SGR (by set)."""
    from collections import Counter

    c = Counter()
    for fe in fes:
        params = [v for v in fe._lr_params.values() if v is not None]
        taps = Counter((tuple(v[1]), tuple(v[2])) for v in params
                       if v[0] == "wiener")
        frame = taps.most_common(1)[0][0] if taps else None
        for v in params:
            if v[0] == "sgr":
                c[f"sgr_set_{v[1]}"] += 1
            elif (tuple(v[1]), tuple(v[2])) == frame:
                c["wiener_frame_taps"] += 1
            else:
                c["wiener_unit_taps"] += 1
        c["units"] += len(fe._lr_params)
    return dict(c)


class ArmCapture:
    """Keeps the largest call (by its luma samples) of the wavefront's CFL
    arm (WavefrontPass._cfl) and of the leaf's chroma (chroma, which
    calls the arm) while open: (the pass, the arguments), by reference."""

    def __init__(self):
        from rav1e_tpu_torch.models import wavefront

        self.calls = {}
        self._undo = []
        for name, luma in (("_cfl", 0), ("chroma", 14)):
            orig = getattr(wavefront.WavefrontPass, name)

            def run(this, *a, _orig=orig, _name=name, _luma=luma):
                n = a[_luma].numel()
                if _name not in self.calls or n > self.calls[_name][0]:
                    self.calls[_name] = (n, this, a)
                return _orig(this, *a)

            setattr(wavefront.WavefrontPass, name, run)
            self._undo.append((name, orig))

    def restore(self):
        from rav1e_tpu_torch.models import wavefront

        for name, orig in self._undo:
            setattr(wavefront.WavefrontPass, name, orig)


def device_ops(fn) -> dict:
    """The device operations one call of fn issues, by torch.profiler:
    kernels (ours and PyTorch's), memsets and copies, by name.  The call
    is profiled twice and the second session read: a process's first
    session has listed PyTorch's kernels but not those loaded through
    ctypes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    names = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            names[e.key[:60]] = names.get(e.key[:60], 0) + e.count
    return {"device_ops": sum(names.values()), "by_name": names}


CFL_ARM_MAX_OPS = 5  # K11's fit, K2, K3, K11's decision and one more


def cfl_arm(arm, card: str, limit=None) -> dict:
    """The CFL arm's and the leaf chroma's device operations a call
    (device_ops) and the arm's times (ms, device_ms, host_ms), on the
    largest call of each the path made; with limit, the arm must issue
    at most that many."""
    _, this, a = arm.calls["_cfl"]
    _, this_c, a_c = arm.calls["chroma"]
    call = lambda: this._cfl(*a)
    ops = device_ops(call)
    out = {"blocks": int(a[0].shape[0]), "n": int(a[0].shape[-1]),
           "arm": dict(ops, **timed(call)),
           "chroma": device_ops(lambda: this_c.chroma(*a_c)), "card": card}
    print(json.dumps({"cfl_arm": out}))
    if limit is not None and ops["device_ops"] > limit:
        raise RuntimeError(f"the CFL arm issues {ops['device_ops']} device "
                           f"operations a call, more than {limit}")
    return out


def speed5(card: str) -> list:
    """The speed-5 path (phase 9 of the module docstring).  Returns the
    kernels JSON entries of K11 and K8's frame mode."""
    import torch

    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.utils.content import make_frames, make_frames_cfl

    frames = make_frames(W, H, SPEED5_FRAMES)
    cap = Capture()
    arm = ArmCapture()
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        data, recon, fes = encode(frames, check=True, speed=5)
        torch.cuda.synchronize()
    finally:
        arm.restore()
        cap.restore()
    t_first = time.perf_counter() - t0
    counts = dict(kernels.COUNTS)
    cfl_bench = encode.cfl_blocks
    print(json.dumps({"speed5_path_launches": counts,
                      "first_encode_s": t_first, "cfl_blocks": cfl_bench,
                      "stages_s": encode.stages, "card": card}))
    missing = [k for k in SPEED5_LAUNCHED if counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the speed-5 path: "
                           f"{missing}")
    ran = [k for k in SPEED5_IDLE if counts[k]]
    if ran:
        raise RuntimeError(f"kernels of the device chain launched on the "
                           f"speed-5 host filter path: {ran}")
    if len(fes) != SPEED5_FRAMES:
        raise RuntimeError(f"{len(fes)} of {SPEED5_FRAMES} frames took the "
                           "wavefront")
    check_decide_launches(counts, cap, SPEED5_FRAMES, "the speed-5 path")
    print(json.dumps({"speed5_bound_ms_per_frame": {
        k: v / SPEED5_FRAMES for k, v in cap.bounds.items()}, "card": card}))
    results = check_speed5_kernels(cap.calls, counts, SPEED5_FRAMES)
    cfl_arm(arm, card, CFL_ARM_MAX_OPS)
    check_modes(cap.calls, "speed5", card)
    print(json.dumps({"speed5_cdef_route": time_cdef_route(cap.calls),
                      "card": card}))
    t1 = time.perf_counter()
    summary = check_output(data, recon, fes, FILTER_FRAMES)
    summary["lr_units"] = lr_units(fes)
    print(json.dumps({"speed5_output": summary, "bytes": sum(map(len, data)),
                      "check_s": time.perf_counter() - t1}))

    # content whose chroma follows its luma: CFL wins blocks
    cfl_frames = make_frames_cfl(W, H, CFL_FRAMES)
    c_data, c_recon, c_fes = encode(cfl_frames, check=True, speed=5)
    cfl_blocks = encode.cfl_blocks
    c_summary = check_output(c_data, c_recon, c_fes, 0)
    c_summary.update(rederive_cfl(c_fes))
    print(json.dumps({"speed5_cfl_content": {
        "frames": CFL_FRAMES, "cfl_blocks": cfl_blocks,
        "cfl_blocks_bench_content": cfl_bench, "output": c_summary}}))
    if cfl_blocks + cfl_bench == 0 or c_summary["cfl_sbs_rederived"] == 0:
        raise RuntimeError("no block chose CFL on the speed-5 path")

    t2 = time.perf_counter()
    data2, _, _ = encode(frames[:SPEED5_TIMED], check=False, speed=5)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t2
    if data2 != data[:SPEED5_TIMED]:
        raise RuntimeError("the second speed-5 encode wrote other bytes")
    print(json.dumps({"speed5_encode": {
        "frames": SPEED5_TIMED, "size": f"{W}x{H}", "seconds": t_enc,
        "fps": SPEED5_TIMED / t_enc, "stages_s": encode.stages, "card": card}}))
    check_every(cap, "speed5", card)

    # the small-frame route: the sampled host CDEF search and
    # cdef_frame_device (coded area under 640x480)
    kernels.reset_counts()
    s_cap = Capture()
    try:
        s_data, s_recon, s_fes = encode(make_frames(320, 240, 1), check=True,
                                        speed=5, size=(320, 240))
    finally:
        s_cap.restore()
    s_counts = dict(kernels.COUNTS)
    if not (s_counts["cdef_dir"] and s_counts["cdef_filter"]) or \
            s_counts["deblock"] or s_counts["wiener_solve"]:
        raise RuntimeError(f"the 320x240 speed-5 key frame launched "
                           f"{s_counts}")
    print(json.dumps({"speed5_small": {
        "launches": s_counts, "bytes": sum(map(len, s_data)),
        "cdef_frame_route": time_cdef_frame(s_cap.calls),
        "output": check_output(s_data, s_recon, s_fes, 1), "card": card}}))

    # 1 key + 1 inter frame at speed 5 (the inter pass; the same host
    # filter path)
    kernels.reset_counts()
    g_frames = make_frames(W, H, GOP5_FRAMES)
    t3 = time.perf_counter()
    g_data, g_recon, g_fes = encode(g_frames, check=True, mixed=True,
                                    speed=5)
    torch.cuda.synchronize()
    t_gop = time.perf_counter() - t3
    g_counts = dict(kernels.COUNTS)
    types = encode.frame_types
    if types != ["key"] + ["inter"] * (GOP5_FRAMES - 1) or \
            sum(fe._chk_wf.has_mv for fe in g_fes) != GOP5_FRAMES - 1:
        raise RuntimeError(f"speed-5 GOP frame types {types}")
    if not (g_counts["mc_pred"] and g_counts["me_fullpel"]
            and g_counts["cfl"]):
        raise RuntimeError(f"speed-5 GOP launches {g_counts}")
    print(json.dumps({"speed5_gop": {
        "frames": GOP5_FRAMES, "seconds": t_gop, "launches": g_counts,
        "output": check_output(g_data, g_recon, g_fes, 1), "card": card}}))
    return results


def frame_path(fe) -> dict:
    """What a default-config frame's encoder took: its path (the inter
    wavefront, or the host inter path) and decisions."""
    return {"path": "wavefront" if fe.wf_inter else "host",
            "ref_ids": list(fe.ref_ids),
            "reference_select": bool(fe.reference_select),
            "comp_block_count": fe.comp_block_count,
            "interp_filter": int(fe.interp_filter),
            "lr_types": [int(t) for t in getattr(fe, "lr_types", ())]}


def check_me_frame(calls, counts, frames_per_run):
    """K10 on the host inter path: every frame_me_map call of the run
    (`calls`: (src, ref, the map K10 wrote)) identical to me_fullpel_plain
    on the same card tensors; the largest timed beside its plain version
    and its bound.  No single PyTorch call computes the search (library_ms
    null).  Returns the kernels JSON list."""
    from rav1e_tpu_torch.models import device_pipeline as dp

    out = []
    entry = make_entry(out, counts, frames_per_run)
    err = max(_same(mv, dp.me_fullpel_plain(s_, r_, 32), "me_fullpel "
                    "(frame_me_map)") for s_, r_, mv in calls)
    s_, r_, _mv = max(calls, key=lambda c: c[0].numel())
    print(json.dumps({"me_fullpel_frame_calls": {
        "calls": len(calls), "identical": len(calls),
        "size": list(s_.shape)}}))
    entry("me_fullpel_frame", "rav1e_tpu_torch/csrc/me_fullpel.cu",
          "rav1e_tpu/models/device_pipeline.py:339", err,
          cuda_ms(lambda: dp.me_fullpel(s_, r_, 32)),
          cuda_ms(lambda: dp.me_fullpel_plain(s_, r_, 32), reps=3),
          WORK["me_fullpel_frame"]((s_, r_), {}))
    return out


def default_gop(card: str) -> list:
    """The default-configuration path (phase 10 of the module docstring).
    Returns the kernels JSON entry of K10 on the host inter path."""
    import torch

    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.models import mv_pred as mvp
    from rav1e_tpu_torch.models.inter_frame import InterFrameEncoder
    from rav1e_tpu_torch.utils import recon_check
    from rav1e_tpu_torch.utils.content import make_frames
    from rav1e_tpu_torch.utils.stream_check import recon_digest

    frames = make_frames(W, H, DEFAULT_FRAMES)
    cap = Capture(keep=("me_fullpel",))
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        data, recon, _wf = encode(frames, check=True, default=True)
        torch.cuda.synchronize()
    finally:
        cap.restore()
    t_first = time.perf_counter() - t0
    # every frame_me_map call's card tensors, for the parity check
    me_calls = [(a[0], a[1], mv) for a, k, mv in cap.every.pop("me_fullpel")
                if k.get("count") == "me_fullpel_frame"]
    counts = dict(kernels.COUNTS)
    fes = encode.all_fes
    stages = encode.stages
    inter = [fe for fe in fes if isinstance(fe, InterFrameEncoder)]
    host = [fe for fe in inter if not fe.wf_inter]
    paths = [frame_path(fe) for fe in inter]
    print(json.dumps({"default_path_launches": counts,
                      "first_encode_s": t_first,
                      "packets": encode.frame_types, "frames": paths,
                      "stages_s": stages, "card": card}))
    if len(fes) != DEFAULT_FRAMES or len(inter) != DEFAULT_FRAMES - 1:
        raise RuntimeError(f"{len(fes)} frames coded of {DEFAULT_FRAMES}")
    if not (inter[0].wf_inter and inter[0].ref_ids == [mvp.LAST_FRAME]):
        raise RuntimeError("the first ALTREF did not take the inter "
                           "wavefront")
    if not any(fe.reference_select and fe.comp_block_count for fe in host):
        raise RuntimeError("no host frame coded compound blocks")
    if not any({mvp.LAST2_FRAME, mvp.GOLDEN_FRAME} & set(fe.ref_ids)
               for fe in inter):
        raise RuntimeError("no frame referenced GOLDEN or LAST2")
    want = sum(len(fe.ref_ids) for fe in host)
    if counts["me_fullpel_frame"] != want or len(me_calls) != want:
        raise RuntimeError(f"K10 ran {counts['me_fullpel_frame']} times on "
                           f"the host path, for {want} references")
    missing = [k for k in DEFAULT_LAUNCHED if counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the default path: "
                           f"{missing}")
    print(json.dumps({"default_bound_ms_per_frame": {
        k: v / DEFAULT_FRAMES for k, v in cap.bounds.items()},
        "card": card}))
    check_modes(cap.calls, "default_gop", card)
    check_every(cap, "default_gop", card)
    results = check_me_frame(me_calls, counts, DEFAULT_FRAMES)
    del me_calls[:]

    t1 = time.perf_counter()
    wf_fes = [fe for fe in fes if hasattr(fe, "_chk_wf")]
    checked, inter_sbs = rederive_sbs(wf_fes)
    for fe in host[:DEFAULT_FILTER_FRAMES]:
        if not recon_check.filters_match(fe, fe._chk_prefilter, fe._chk_out):
            raise RuntimeError("a host frame's numpy filter chain over its "
                               "pre-filter frame differs from the output")
    digests = [recon_digest(r) for r in recon]
    print(json.dumps({"default_output": {
        "dav1d": check_decode(data, recon), "sbs_rederived": checked,
        "sbs_rederived_with_inter_blocks": inter_sbs,
        "host_frames_filter_chain_np": DEFAULT_FILTER_FRAMES,
        "recon_sha256": digests},
        "bytes": sum(map(len, data)), "check_s": time.perf_counter() - t1}))
    save_stream("default", data, {"recon_sha256": digests})
    # the counted encode's own seconds (no second encode: see HBD_FRAMES)
    print(json.dumps({"default_encode": {
        "frames": DEFAULT_FRAMES, "size": f"{W}x{H}", "seconds": t_first,
        "fps": DEFAULT_FRAMES / t_first, "stages_s": stages,
        "counted_encode": True, "card": card}}))
    return results


# phase 11, above 8 bits: every frame is off the wavefront (8-bit only), so
# the key frame's host walk reads frame_rd_maps (K1, K2's float variant),
# the inter frames take the host inter path (K10 on uint16 planes), and
# every frame the host filter path (K5, K6 at bd, K8's frame mode at bd)
HBD_LAUNCHED = ("intra_pred", "fwd_txq", "cdef_dir", "cdef_filter",
                "me_fullpel_frame", "wiener_lr_frame", "frame_rd_maps")
# the wavefront (and its ME and inverse transforms), the chain, CFL
HBD_IDLE = ("deblock", "wiener_solve", "wiener_lr", "mc_pred", "cfl",
            "cfl_decide", "me_fullpel", "fwd_txq_thin", "inv_txfm")


@contextlib.contextmanager
def plain_kernels():
    """rd_analysis through the plain versions of K1 and K2's float
    variant (the card's frame_rd_maps without its kernels)."""
    from rav1e_tpu_torch.ops import intra, transforms as tt

    saved = intra.intra_pred, tt.fwd_rd_float
    intra.intra_pred, tt.fwd_rd_float = (intra.intra_pred_plain,
                                         tt.fwd_rd_float_plain)
    try:
        yield
    finally:
        intra.intra_pred, tt.fwd_rd_float = saved


def rd_map_ties(got, ref, table_of) -> int:
    """frame_rd_maps (K1 + K2) against its plain version on the card:
    modes, nnz and split32 identical except at blocks whose two best plain
    costs lie within RD_TIE of each other; returns their count (at most
    FDCT_TIE_SHARE of the blocks)."""
    import numpy as np

    ties = blocks = 0
    for n in (32, 16):
        (m, c, z), (rm, rc, rz) = got[n], ref[n]
        if not np.allclose(c, rc, rtol=1e-4):
            raise RuntimeError(f"frame_rd_maps costs differ at n = {n}")
        table = np.sort(table_of(n), 0)
        near = table[1] - table[0] <= RD_TIE * table[0]
        differ = (m != rm) | (z != rz)
        if (differ & ~near).any():
            raise RuntimeError(f"frame_rd_maps modes differ away from ties "
                               f"at n = {n}")
        ties += int(differ.sum())
        blocks += m.size
    c32 = got[32][1]
    by, bx = c32.shape
    gap = np.abs(got[16][1].reshape(by, 2, bx, 2).sum((1, 3)) - c32)
    differ = got["split32"] != ref["split32"]
    if (differ & (gap > 1e-3 * np.abs(c32))).any():
        raise RuntimeError("frame_rd_maps split32 differs away from ties")
    ties += int(differ.sum())
    if ties > FDCT_TIE_SHARE * blocks:
        raise RuntimeError(f"frame_rd_maps: {ties} of {blocks} at ties")
    return ties


def check_rd_maps(calls, rd_args, counts):
    """frame_rd_maps on the key frame's plane: the maps of K1 + K2 against
    those of their plain versions (rd_map_ties), K1's largest call
    identical, K2's float variant by its tie rule; each timed beside its
    bound, K2 beside the torch.matmul forward transform of the same
    residual batch, and the whole route beside its plain version.
    Returns (kernels JSON entries, the route's timing)."""
    import torch

    from rav1e_tpu_torch.models import device_pipeline as dp
    from rav1e_tpu_torch.ops import transforms as tt

    out = []
    entry = make_entry(out, counts, HBD_FRAMES)
    y, dc_q, ac_q, lam = rd_args
    dev = calls["frame_rd_maps_intra_pred"][1][0].device  # the route's
    got = dp.frame_rd_maps(y, dc_q, ac_q, lam, device=dev)
    with plain_kernels():
        ref = dp.frame_rd_maps(y, dc_q, ac_q, lam, device=dev)
    yt = torch.as_tensor(y, device=dev)
    lam_t = torch.tensor(float(lam), dtype=torch.float32)

    def table_of(n):
        blocks, stack = dp.predict_all(yt, n)
        Fv, FhT = dp._fwd_mats(n, yt.device)
        d, r, _z = tt.fwd_rd_float_plain(blocks[None] - stack, Fv, FhT,
                                         dc_q, ac_q, 1 if n == 32 else 0)
        return (d * dp.DIST_SCALE[n] + lam_t * (r + 6.0)).cpu().numpy()

    ties = rd_map_ties(got, ref, table_of)
    _, a, k = calls["frame_rd_maps_intra_pred"]
    r = k1_check("intra_pred (frame_rd_maps)", a, k, reps=5, plain_reps=3)
    entry("frame_rd_maps_intra_pred", "rav1e_tpu_torch/csrc/intra_pred.cu",
          "rav1e_tpu/models/device_pipeline.py:49", r["err"], r["ms"],
          r["plain_ms"], r["work"], device_ms=r["device_ms"],
          host_ms=r["host_ms"])
    _, a, _k = calls["fwd_rd_float"]
    d1, r1, z1 = tt.fwd_rd_float(*a)
    d2, r2, z2 = tt.fwd_rd_float_plain(*a)
    close = (torch.isclose(d1, d2, rtol=1e-3)
             & torch.isclose(r1, r2, rtol=1e-3) & (z1 == z2))
    agree = float(close.float().mean())
    if agree < 1 - FDCT_TIE_SHARE:
        raise RuntimeError(f"fwd_txq float variant agrees on {agree:.4f}")
    fwd_in_place("frame_rd_maps_fwd_txq", a[0], a[1][None], a[2][None],
                 None, a[3], a[4], None)
    t = fwd_times(lambda: tt.fwd_rd_float(*a), a)
    entry("frame_rd_maps_fwd_txq", "rav1e_tpu_torch/csrc/fwd_txq.cu",
          "rav1e_tpu/models/device_pipeline.py:156",
          float((d1 - d2).abs().max()), t["ms"],
          cuda_ms(lambda: tt.fwd_rd_float_plain(*a), reps=3),
          WORK["fwd_rd_float"](a, {}), library_ms=t["library_ms"],
          device_ms=t["device_ms"],
          library_device_ms=t["library_device_ms"])

    def plain_route():
        with plain_kernels():
            dp.frame_rd_maps(y, dc_q, ac_q, lam, device=dev)

    route = {"ms": cuda_ms(lambda: dp.frame_rd_maps(y, dc_q, ac_q, lam,
                                                    device=dev), reps=3),
             "plain_ms": cuda_ms(plain_route, reps=2),
             "blocks_at_ties": ties, "fwd_float_agree": agree,
             "size": list(y.shape)}
    return out, route


def check_hbd_calls(every, counts, bd):
    """Every K5, K8 frame-mode and K10 call of the path (`every`,
    Capture.every) identical to its plain version on the same card
    tensors, each at bd, and every K6 call (search and apply; its parity
    is check_every's) at bd; the largest of each timed beside its plain
    version and its bound.  Returns the kernels JSON entries."""
    import torch

    from rav1e_tpu_torch.models import device_pipeline as dp
    from rav1e_tpu_torch.ops import cdef, lrf

    out = []
    entry = make_entry(out, counts, HBD_FRAMES)
    n = {}
    for a, k, o in every["cdef_dir"]:
        if a[1] != bd:
            raise RuntimeError(f"cdef_dir ran at {a[1]} bits")
        _same(o, cdef.cdef_dir_plain(*a), f"cdef_dir at {bd} bits")
    for a, k, o in every["cdef_filter"]:
        if a[12] != bd:
            raise RuntimeError(f"cdef_filter ran at {a[12]} bits")
    for a, k, o in every["wiener_filter_frame"]:
        if a[6] != bd:
            raise RuntimeError(f"wiener_lr frame mode ran at {a[6]} bits")
        _same(o, _wiener_plain(a), f"wiener_lr frame mode at {bd} bits")
    me = [(a, o) for a, k, o in every["me_fullpel"]
          if k.get("count") == "me_fullpel_frame"]
    for a, o in me:
        if a[0].dtype != torch.uint16:
            raise RuntimeError("frame_me_map did not search uint16 planes")
        _same(o, dp.me_fullpel_plain(a[0], a[1], 32),
              "me_fullpel (frame_me_map, uint16)")
    for key in every:
        n[key] = len(every[key])
    print(json.dumps({"hbd_calls_identical": n}))
    big = lambda key: max(every[key], key=lambda c: c[0][0].numel())[0]
    d = big("cdef_dir")
    entry("cdef_dir_hbd", "rav1e_tpu_torch/csrc/cdef_dir.cu",
          "rav1e_tpu/ops/cdef_jax.py:43", 0,
          cuda_ms(lambda: cdef.cdef_dir(*d)),
          cuda_ms(lambda: cdef.cdef_dir_plain(*d), reps=5),
          WORK["cdef_dir"](d, {}))
    # the search and the apply of the largest frame (the apply alone on
    # cdef_frame_device's route, under 640x480)
    k6 = [max((c[0] for c in every["cdef_filter"] if c[0][10] == mode),
              key=lambda a: a[0].numel())
          for mode in (cdef.SEARCH, cdef.APPLY)]
    r = k6_times("cdef_filter_hbd_calls", *k6)
    entry("cdef_filter_hbd", "rav1e_tpu_torch/csrc/cdef_filter.cu",
          "rav1e_tpu/ops/cdef_jax.py:234", 0, r["ms"],
          sum(cuda_ms(lambda a=a: cdef.cdef_filter_plain(*a), reps=3)
              for a in k6), r["work"], device_ms=r["device_ms"],
          host_ms=r["host_ms"])
    w_a = big("wiener_filter_frame")
    entry("wiener_lr_frame_hbd", "rav1e_tpu_torch/csrc/wiener_lr.cu",
          "rav1e_tpu/ops/lrf_jax.py:43", 0,
          cuda_ms(lambda: lrf.wiener_filter_frame(*w_a)),
          cuda_ms(lambda: _wiener_plain(w_a), reps=5),
          WORK["wiener_lr_frame"](w_a, {}))
    s_, r_ = max(me, key=lambda c: c[0][0].numel())[0][:2]
    entry("me_fullpel_frame_hbd", "rav1e_tpu_torch/csrc/me_fullpel.cu",
          "rav1e_tpu/models/device_pipeline.py:339", 0,
          cuda_ms(lambda: dp.me_fullpel(s_, r_, 32)),
          cuda_ms(lambda: dp.me_fullpel_plain(s_, r_, 32), reps=3),
          WORK["me_fullpel_frame"]((s_, r_), {}))
    return out


def check_12bit_kernels(device: str = "cuda") -> dict:
    """K5, K6 (search and apply), K8's frame mode (stripes 64 and 32) and
    K10 on seeded 1920x1088 12-bit planes with maximum-contrast blocks
    (0 and 4095 side by side: a superblock's SSE beyond 2^31), each
    identical to its plain version.  Returns what was checked."""
    import numpy as np
    import torch

    from rav1e_tpu_torch.models import device_pipeline as dp
    from rav1e_tpu_torch.ops import cdef, lrf

    bd, mx, h, w = 12, 4095, 1088, 1920
    rng = np.random.default_rng(12)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                  device=device)

    def plane(hh, ww):
        src = rng.integers(0, mx + 1, (hh, ww))
        src = (src + np.roll(src, 1, 0) + np.roll(src, 1, 1)) // 3
        rec = np.clip(src + rng.integers(-200, 201, src.shape), 0, mx)
        cb = (np.arange(hh)[:, None] // 8 + np.arange(ww) // 8) % 2
        rec[: hh // 4] = cb[: hh // 4] * mx  # maximum contrast
        src[: hh // 4] = mx - rec[: hh // 4]
        return t(src), t(rec)

    (sy, y), (su, u), (sv, v) = (plane(h, w), plane(h // 2, w // 2),
                                 plane(h // 2, w // 2))
    dirs, var = cdef.cdef_dir(y, bd)
    _same((dirs, var), cdef.cdef_dir_plain(y, bd), "cdef_dir at 12 bits")
    act = t(rng.random((h // 8, w // 8)) < 0.9).to(torch.bool)
    args = (y, u, v, sy, su, sv, dirs, var, act, 4 + bd - 8)
    sse = cdef.cdef_filter(*args, cdef.SEARCH, None, bd)
    _same(sse, cdef.cdef_filter_plain(*args, cdef.SEARCH, None, bd),
          "cdef_filter search at 12 bits")
    if int(sse.max()) < 2 ** 31:
        raise RuntimeError("the 12-bit planes did not reach 2^31 SSE")
    idx = t(rng.integers(0, 8, (h // 64, w // 64)))
    got = cdef.cdef_filter(*args, cdef.APPLY, idx, bd)
    _same(got, cdef.cdef_filter_plain(*args, cdef.APPLY, idx, bd),
          "cdef_filter apply at 12 bits")
    taps = {64: t([[3, -7, 15], [-2, 5, 12]]), 32: t([[0, -7, 15],
                                                      [0, 5, 12]])}
    for stripe, (cd, db) in ((64, (got[0], y)), (32, (got[1], u))):
        hh, ww = cd.shape
        a = (cd, db, taps[stripe], stripe, hh, ww, bd)
        out = lrf.wiener_filter_frame(*a)
        _same(out, _wiener_plain(a), f"wiener_lr frame mode at 12 bits, "
              f"stripe {stripe}")
        if int(out.max()) != mx:
            raise RuntimeError("the 12-bit Wiener output never clipped")
    s16 = sy.to(torch.uint16)
    r16 = torch.roll(sy, (3, -6), (0, 1)).to(torch.uint16)
    mv = dp.me_fullpel(s16, r16, 32, count="me_fullpel_frame")
    _same(mv, dp.me_fullpel_plain(s16, r16, 32), "me_fullpel at 12 bits")
    return {"size": [h, w], "bd": bd, "sse_max": int(sse.max()),
            "identical": ["cdef_dir", "cdef_filter search", "cdef_filter "
                          "apply", "wiener_lr frame 64", "wiener_lr frame 32",
                          "me_fullpel uint16"]}


def small_hbd_encodes() -> dict:
    """A 320x240 12-bit 1 key + 1 inter encode (the key frame on
    frame_rd_maps, CDEF by the sampled search and cdef_frame_device) and
    a 320x240 8-bit lossless key frame (frame_rd_maps at q 0, no loop
    filter), the latter through FrameEncoder since the Context refuses
    quantizer 0 (ROADMAP F6): their paths, launches and recon digests."""
    from rav1e_tpu_torch import Config, EncoderConfig, kernels
    from rav1e_tpu_torch.models.pipeline import FrameEncoder
    from rav1e_tpu_torch.utils.content import make_frames
    from rav1e_tpu_torch.utils.stream_check import recon_digest

    def lossless():
        enc = EncoderConfig(width=320, height=240, quantizer=0,
                            rdo_lookahead_frames=8)
        try:
            Config(enc=enc).new_context()
        except NotImplementedError:
            pass
        else:
            raise RuntimeError("the Context took quantizer 0 (F6)")
        fe = FrameEncoder(enc)
        data = fe.encode_key_frame(make_frames(320, 240, 1)[0])
        return [data], [fe.last_recon]

    out = {}
    for name, bd, nf in (("12bit_320x240", 12, 2),
                         ("lossless_320x240", 8, 1)):
        kernels.reset_counts()
        cap = Capture()
        try:
            if bd > 8:
                data, recon, _wf = encode(
                    make_frames(320, 240, nf, bit_depth=bd), check=False,
                    default=True, size=(320, 240), bit_depth=bd)
            else:
                data, recon = lossless()
        finally:
            cap.restore()
        counts = {k: v for k, v in kernels.COUNTS.items() if v}
        if counts.get("frame_rd_maps") != 1:
            raise RuntimeError(f"{name}: the key frame did not take "
                               "frame_rd_maps")
        if bd > 8 and not counts.get("cdef_filter"):
            raise RuntimeError(f"{name}: cdef_frame_device did not run")
        out[name] = {"launches": counts, "bytes": sum(map(len, data)),
                     "recon_sha256": [recon_digest(r, bd) for r in recon]}
        if bd > 8:  # the small-frame CDEF route at 12 bits, timed
            out[name]["cdef_frame_route"] = time_cdef_frame(cap.calls)
    return out


def hbd_gop(card: str) -> list:
    """The path above 8 bits (phase 11 of the module docstring).  Returns
    the kernels JSON entries of its routes."""
    import torch

    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.models.inter_frame import InterFrameEncoder
    from rav1e_tpu_torch.utils import recon_check
    from rav1e_tpu_torch.utils.content import make_frames
    from rav1e_tpu_torch.utils.stream_check import recon_digest

    frames = make_frames(W, H, HBD_FRAMES, bit_depth=HBD_BD)
    cap = Capture(keep=("cdef_dir", "cdef_filter", "wiener_filter_frame",
                        "me_fullpel", "frame_rd_maps"))
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        data, recon, wf = encode(frames, check=True, default=True,
                                 bit_depth=HBD_BD)
        torch.cuda.synchronize()
    finally:
        cap.restore()
    t_first = time.perf_counter() - t0
    counts = dict(kernels.COUNTS)
    fes = encode.all_fes
    stages = encode.stages
    inter = [fe for fe in fes if isinstance(fe, InterFrameEncoder)]
    paths = [dict(frame_path(fe),
                  cdef_strengths=list(fe.cdef_strengths or ()),
                  cdef_per_sb=fe.cdef_sb is not None) for fe in inter]
    print(json.dumps({"hbd_path_launches": counts, "first_encode_s": t_first,
                      "packets": encode.frame_types,
                      "key_frame": {"cdef_strengths":
                                    list(fes[0].cdef_strengths or ()),
                                    "lr_types": [int(x) for x in
                                                 fes[0].lr_types]},
                      "frames": paths, "stages_s": stages,
                      "card": card}))
    if wf or len(fes) != HBD_FRAMES or len(inter) != HBD_FRAMES - 1:
        raise RuntimeError(f"{len(wf)} wavefront frames, {len(fes)} coded "
                           f"of {HBD_FRAMES}")
    if len(cap.every["frame_rd_maps"]) != 1 or \
            fes[0]._rd_maps is None or counts["frame_rd_maps"] != 1:
        raise RuntimeError("the key frame did not take frame_rd_maps")
    if counts["intra_pred"] != 2 or counts["fwd_txq"] != 2:
        raise RuntimeError("frame_rd_maps did not launch K1 and K2 twice")
    if not any(fe.reference_select and fe.comp_block_count for fe in inter):
        raise RuntimeError("no host frame coded compound blocks")
    want = sum(len(fe.ref_ids) for fe in inter)
    if counts["me_fullpel_frame"] != want:
        raise RuntimeError(f"K10 ran {counts['me_fullpel_frame']} times "
                           f"for {want} references")
    if len([c for c in cap.every["cdef_dir"] if c[0][1] == HBD_BD]) \
            != HBD_FRAMES:
        raise RuntimeError("CDEF did not run at 10 bits on every frame")
    missing = [k for k in HBD_LAUNCHED if counts[k] == 0]
    busy = [k for k in HBD_IDLE if counts[k]]
    if missing or busy:
        raise RuntimeError(f"phase 11 kernels not launched: {missing}, "
                           f"launched off the path: {busy}")
    print(json.dumps({"hbd_bound_ms_per_frame": {
        k: v / HBD_FRAMES for k, v in cap.bounds.items()}, "card": card}))
    key = fes[0]
    names = {"frame_rd_maps_intra_pred": counts["intra_pred"],
             "frame_rd_maps_fwd_txq": counts["fwd_txq"],
             "cdef_dir_hbd": counts["cdef_dir"],
             "cdef_filter_hbd": counts["cdef_filter"],
             "wiener_lr_frame_hbd": counts["wiener_lr_frame"],
             "me_fullpel_frame_hbd": counts["me_fullpel_frame"]}
    results, route = check_rd_maps(cap.calls, (key.src[0], key.dc_q,
                                               key.ac_q, key.lam), names)
    route["bound_ms"] = cap.bounds.get("rd_maps", 0.0)
    print(json.dumps({"frame_rd_maps_route": route, "card": card}))
    results += check_hbd_calls(cap.every, names, HBD_BD)
    check_every(cap, "hbd_gop", card)
    cap.every.clear()
    print(json.dumps({"hbd_12bit_kernels": check_12bit_kernels()}))
    print(json.dumps({"hbd_small_encodes": small_hbd_encodes()}))

    t1 = time.perf_counter()
    for fe in fes[:HBD_FILTER_FRAMES]:
        if not recon_check.filters_match(fe, fe._chk_prefilter, fe._chk_out):
            raise RuntimeError("a 10-bit frame's numpy filter chain over its "
                               "pre-filter frame differs from the output")
    digests = [recon_digest(r, HBD_BD) for r in recon]
    print(json.dumps({"hbd_output": {
        "dav1d": check_decode(data, recon),
        "frames_filter_chain_np": HBD_FILTER_FRAMES,
        "recon_sha256": digests},
        "bytes": sum(map(len, data)), "check_s": time.perf_counter() - t1}))
    save_stream("hbd", data, {"recon_sha256": digests, "bit_depth": HBD_BD})
    # the counted encode's own seconds (no second encode: see HBD_FRAMES)
    print(json.dumps({"hbd_encode": {
        "frames": HBD_FRAMES, "size": f"{W}x{H}", "bit_depth": HBD_BD,
        "seconds": t_first, "fps": HBD_FRAMES / t_first,
        "stages_s": stages, "counted_encode": True, "card": card}}))
    return results


# phase 12, speed 3: the keyframe pass with its 8x8 level (and CFL), then
# the host filter path of speed 5
# key frames: the Context runs frame 0's pass alone and batches frames
# 1-2 (launch_wavefront_batch, F = 2)
SPEED3_FRAMES = 3
SPLIT8_SAMPLES = 8  # superblocks holding 8x8 leaves re-derived a frame
CLI_SIZE, CLI_FRAMES = (320, 240), 2


def rederive_split8(fes, limit: int = SPLIT8_SAMPLES) -> dict:
    """Up to `limit` device superblocks a frame that hold 8x8 leaves
    (seeded sample), re-derived from their records with the numpy oracles
    onto the pre-filter recon (their 8x8 leaves' edges from the geometry's
    avail8, recon_check._block_avail)."""
    import numpy as np

    from rav1e_tpu_torch.utils import recon_check

    rng = np.random.default_rng(0)
    sbs = leaves = 0
    for fe in fes:
        wf = fe._chk_wf
        g = wf.geom
        have = [(int(r), int(c)) for r, c in np.argwhere(g.device_sb)
                if not wf.none64[g.sb_step[r, c], g.sb_lane[r, c]]
                and (wf.split[g.sb_step[r, c], :, g.sb_lane[r, c], None]
                     & wf.split16[g.sb_step[r, c], :, :,
                                  g.sb_lane[r, c]]).any()]
        for i in rng.choice(len(have), min(limit, len(have)), replace=False):
            r, c = have[i]
            if not recon_check.rederive_sb(wf, fe._chk_prefilter, r, c,
                                           fe.dc_q, fe.ac_q):
                raise RuntimeError(f"SB ({r}, {c}) with 8x8 leaves does not "
                                   "re-derive")
            sbs += 1
            leaves += sum(b[2] == 8 for b in wf.sb_records(r, c))
    return {"split8_sbs_rederived": sbs, "split8_leaves_in_them": leaves}


def check_leaf_kernels(calls, ncalls, counts, frames_per_run,
                       keys=SPEED3_SHAPES):
    """K1, K2, K3 and K11 on the largest call under each key of `keys`
    (by default each shape the speed-3 pass adds, SPEED3_SHAPES; the key
    names the kernel by its prefix): identical to the plain version (K2
    up to its counted fp32 rounding ties), each timed beside its plain
    version, its bound and, for K2, the torch.matmul forward transform.
    `launches` is the kernel's count on the phase's run, `shape_launches`
    its calls at the shape.  Returns the kernels JSON list."""
    from rav1e_tpu_torch.ops import intra

    out = []
    entry = make_entry(out, counts, frames_per_run)
    for key in keys:
        _, a, k = calls[key]
        if key.startswith("intra_pred"):
            r = k1_check(key, a, k)
            entry(key, "rav1e_tpu_torch/csrc/intra_pred.cu",
                  "rav1e_tpu/ops/intra_jax.py:305"
                  if k1_call(a, k)["race"] else
                  "rav1e_tpu/models/wavefront.py:520", r["err"], r["ms"],
                  r["plain_ms"], r["work"], device_ms=r["device_ms"],
                  host_ms=r["host_ms"])
        elif key.startswith("fwd_txq"):
            fwd_entry(entry, key, "rav1e_tpu/ops/transforms_jax.py:465", a, k)
        elif key.startswith("inv_txfm"):
            r = k3_check(key, a, k)
            entry(key, "rav1e_tpu_torch/csrc/inv_txfm.cu",
                  "rav1e_tpu/ops/transforms_jax.py:432", r["err"], r["ms"],
                  r["plain_ms"], r["work"], device_ms=r["device_ms"],
                  host_ms=r["host_ms"])
        else:
            err = _same(intra.cfl(*a), intra.cfl_plain(*a), key)
            entry(key, "rav1e_tpu_torch/csrc/cfl.cu",
                  "rav1e_tpu/ops/intra_jax.py:317", err,
                  cuda_ms(lambda: intra.cfl(*a)),
                  cuda_ms(lambda: intra.cfl_plain(*a)), WORK["cfl"](a, {}))
        first = a[0][0] if isinstance(a[0], (tuple, list)) else a[0]
        lead = first.shape[:1] if key.startswith("intra_pred") else \
            first.shape[:-2]
        out[-1].update(shape_launches=ncalls[key],
                       shape_launches_per_frame=ncalls[key] / frames_per_run,
                       largest_call=list(lead) + [int(first.shape[-1])])
    return out


def serial_pass(fe, card: str) -> dict:
    """The pass of one key frame of a batch alone (F = 1), launched anew
    from its finished encoder (with the key frame's initial CDFs back, as
    prepare sets them: its mode-bit tables come from them) and ended by a
    synchronize: its seconds serialised.  Raises unless its records equal
    the frame's slot of the batched pass."""
    import numpy as np
    import torch

    from rav1e_tpu_torch.entropy.cdf import CdfContext
    from rav1e_tpu_torch.models import wavefront

    adapted, fe.cdf = fe.cdf, CdfContext(fe.q)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launched = wavefront.launch_wavefront(fe, fe._tile_grid())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        fe.cdf = adapted
    res = launched.collect()
    if not np.array_equal(res.packed, fe._chk_wf.packed):
        raise RuntimeError("the pass of one frame alone wrote other records "
                           "than its slot of the batched pass")
    return {"serial_pass_s": secs, "steps": res.geom.steps,
            "lanes": res.geom.width, "records_equal_batched": True,
            "card": card}


def cli_on_card(card: str, device: str = "cuda") -> dict:
    """The port's CLI (`python -m rav1e_tpu_torch in.y4m -o out.ivf -s 3
    --psnr --reconstruction rec.y4m`, its main() in this process) on
    CLI_FRAMES frames of CLI_SIZE bench content at its defaults: the key
    frame's device superblocks re-derive from its records, the numpy
    filters over them give the written y4m's first frame, the stream
    decodes to the y4m where libdav1d loads, and the PSNR it prints is
    frame_psnr's of the y4m against the source."""
    import io
    import tempfile

    import numpy as np

    from rav1e_tpu_torch.__main__ import main as cli_main
    from rav1e_tpu_torch.models.intra_frame import IntraFrameEncoder
    from rav1e_tpu_torch.obu.ivf import read_ivf
    from rav1e_tpu_torch.utils import recon_check
    from rav1e_tpu_torch.utils.content import make_frames
    from rav1e_tpu_torch.utils.frame import (read_y4m, write_y4m_frame,
                                             write_y4m_header)
    from rav1e_tpu_torch.utils.metrics import frame_psnr

    w, h = CLI_SIZE
    frames = make_frames(w, h, CLI_FRAMES, seed=3)
    with tempfile.TemporaryDirectory() as d:
        src, ivf, rec = (str(Path(d) / n) for n in ("in.y4m", "out.ivf",
                                                     "rec.y4m"))
        with open(src, "wb") as fh:
            write_y4m_header(fh, w, h)
            for f in frames:
                write_y4m_frame(fh, f)
        err = io.StringIO()
        t0 = time.perf_counter()
        with checked() as (seen, all_fes), contextlib.redirect_stderr(err):
            rc = cli_main([src, "-o", ivf, "-s", "3", "--psnr",
                           "--reconstruction", rec, "--device", device])
        secs = time.perf_counter() - t0
        with open(rec, "rb") as fh:
            recon = [[p.window().astype(np.int32) for p in f.planes]
                     for f in read_y4m(fh)[1]]
        with open(ivf, "rb") as fh:
            data = [pkt for _pts, pkt in read_ivf(fh)]
    keys = [fe for fe in seen if type(fe) is IntraFrameEncoder]
    if rc != 0 or len(recon) != CLI_FRAMES or len(keys) != 1:
        raise RuntimeError(f"the CLI returned {rc}, {len(recon)} frames, "
                           f"{len(keys)} key frames on the wavefront")
    key = keys[0]
    wf = key._chk_wf
    sbs = [(int(r), int(c)) for r, c in np.argwhere(wf.geom.device_sb)]
    for r, c in sbs:
        if not recon_check.rederive_sb(wf, key._chk_prefilter, r, c,
                                       key.dc_q, key.ac_q):
            raise RuntimeError(f"CLI key frame SB ({r}, {c}) does not "
                               "re-derive")
    if not recon_check.filters_match(key, key._chk_prefilter, recon[0]):
        raise RuntimeError("the CLI's key frame: the numpy filters over its "
                           "re-derived recon differ from the written y4m")
    psnr = [frame_psnr(r, [p.window().astype(np.int32) for p in f.planes])
            ["combined"] for r, f in zip(recon, frames)]
    line = err.getvalue().strip().splitlines()[-1]
    if f"PSNR avg {np.mean(psnr):.2f} dB" not in line:
        raise RuntimeError(f"the CLI printed {line!r}, frame_psnr gives "
                           f"{np.mean(psnr):.2f}")
    return {"frames": CLI_FRAMES, "size": f"{w}x{h}", "seconds": secs,
            "bytes": sum(map(len, data)), "cli_line": line,
            "psnr_combined": psnr, "key_sbs_rederived": len(sbs),
            "key_8x8_leaves": int(wf.split16_map.sum()) * 4,
            "frames_on_wavefront": len(seen),
            "dav1d": check_decode(data, recon), "card": card}


def speed3(card: str) -> list:
    """The speed-3 path (phase 12 of the module docstring).  Returns the
    kernels JSON entries of the shapes its 8x8 level adds."""
    import torch

    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.utils.content import make_frames
    from rav1e_tpu_torch.utils.stream_check import recon_digest

    frames = make_frames(W, H, SPEED3_FRAMES)
    cap = Capture(shapes=True)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        data, recon, fes = encode(frames, check=True, speed=3)
        torch.cuda.synchronize()
    finally:
        cap.restore()
    t_enc = time.perf_counter() - t0
    counts = dict(kernels.COUNTS)
    leaves = [int(fe._chk_wf.split16_map.sum()) * 4 for fe in fes]
    print(json.dumps({"speed3_path_launches": counts,
                      "shape_calls": {k: cap.ncalls[k]
                                      for k in SPEED3_SHAPES},
                      "leaves_8x8_per_frame": leaves, "card": card}))
    print(json.dumps({"speed3_encode": {
        "frames": SPEED3_FRAMES, "size": f"{W}x{H}", "seconds": t_enc,
        "fps": SPEED3_FRAMES / t_enc, "stages_s": encode.stages,
        "card": card}}))
    missing = [k for k in SPEED5_LAUNCHED if counts[k] == 0]
    ran = [k for k in SPEED5_IDLE if counts[k]]
    absent = [k for k in SPEED3_SHAPES if k not in cap.calls]
    if missing or ran or absent:
        raise RuntimeError(f"speed 3: not launched {missing}, launched off "
                           f"the path {ran}, shapes not called {absent}")
    if len(fes) != SPEED3_FRAMES or min(leaves) == 0:
        raise RuntimeError(f"{len(fes)} of {SPEED3_FRAMES} frames took the "
                           f"wavefront; 8x8 leaves a frame {leaves}")
    print(json.dumps({"speed3_bound_ms_per_frame": {
        k: v / SPEED3_FRAMES for k, v in cap.bounds.items()}, "card": card}))
    shape_counts = {key: counts[key.split("_n")[0]] for key in SPEED3_SHAPES}
    results = check_leaf_kernels(cap.calls, cap.ncalls, shape_counts,
                                   SPEED3_FRAMES)
    check_modes(cap.calls, "speed3", card)
    check_every(cap, "speed3", card)
    t1 = time.perf_counter()
    digests = [recon_digest(r) for r in recon]
    print(json.dumps({"speed3_output": {
        "dav1d": check_decode(data, recon), **rederive_split8(fes),
        "recon_sha256": digests}, "bytes": sum(map(len, data)),
        "check_s": time.perf_counter() - t1}))
    save_stream("speed3", data, {"recon_sha256": digests})
    print(json.dumps({"speed3_serial_pass": serial_pass(fes[-1], card)}))
    print(json.dumps({"speed3_cli": cli_on_card(card)}))
    return results


TILE_SIZE, TILE_FRAMES, TILE_COLS = (2560, 1600), 1, 4  # WQXGA: 40 x 25 SBs
TILE_KERNELS = ("intra_pred", "fwd_txq", "inv_txfm")
# the host filter path of the route's frames: K5 and K6 through the CDEF
# search outside the chain; the chain's K4 deblock, K7 tap solve and K8's
# chain mode stay idle (the route has no device-resident recon)
TILE_LAUNCHED = TILE_KERNELS + ("cdef_dir", "cdef_filter")
TILE_IDLE = ("deblock", "wiener_solve", "wiener_lr", "mc_pred",
             "me_fullpel", "cfl", "cfl_decide", "frame_rd_maps")
TILE_EDGE_SAMPLES = 4  # rows sampled on each side of each tile boundary
RESUME_SIZE, RESUME_FRAMES = (320, 240), 3


def _records(wf, r, c) -> list:
    import numpy as np

    return [tuple(np.asarray(x).tobytes() for x in rec)
            for rec in wf.sb_records(r, c)]


def rederive_tile_edges(fe) -> int:
    """TILE_EDGE_SAMPLES superblock rows (seeded) on both sides of each
    tile boundary of a route frame, re-derived from their tile's records
    with the numpy oracles onto that tile's columns of the pre-filter
    recon (a tile's edges never read across it).  Returns the count."""
    import numpy as np

    from rav1e_tpu_torch.utils import recon_check

    wf = fe._chk_wf
    tw = wf.tile_w_sb
    rows = wf.geom.device_sb.shape[0]
    rng = np.random.default_rng(0)
    n = 0
    for t in range(1, len(wf.tile_results)):
        for r in rng.choice(rows, TILE_EDGE_SAMPLES, replace=False):
            for tile, c in ((t - 1, tw - 1), (t, 0)):
                x0 = tile * tw * 64
                pre = [p[:, x0 >> (i > 0) : (x0 + tw * 64) >> (i > 0)]
                       for i, p in enumerate(fe._chk_prefilter)]
                if not recon_check.rederive_sb(wf.tile_results[tile], pre,
                                               int(r), c, fe.dc_q, fe.ac_q):
                    raise RuntimeError(f"tile {tile} SB ({r}, {c}) next to "
                                       "a tile boundary does not re-derive")
                n += 1
    return n


def serial_tile_pass(fe, card: str) -> dict:
    """The tile route's pass of one frame alone (the key frame's initial
    CDFs back, as in serial_pass), ended by a synchronize: its seconds
    serialised.  Raises unless its records equal the encode's."""
    import torch

    from rav1e_tpu_torch.entropy.cdf import CdfContext
    from rav1e_tpu_torch.parallel import tiles

    adapted, fe.cdf = fe.cdf, CdfContext(fe.q)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tiles.run_wavefront_sharded(fe, fe._tile_grid(),
                                          fe.wavefront_mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        fe.cdf = adapted
    dev = res.geom.device_sb
    if any(_records(res, r, c) != _records(fe._chk_wf, r, c)
           for r, c in zip(*dev.nonzero())):
        raise RuntimeError("the route's pass alone wrote other records")
    g = res.tile_results[0].geom
    return {"serial_pass_s": secs, "steps": g.steps,
            "lanes": g.width * len(res.tile_results), "card": card}


def resume_on_card(card: str, device: str = "cuda") -> dict:
    """The CLI with --shard-dir (its main() here) on a RESUME_FRAMES-frame
    RESUME_SIZE clip with key frame interval 1 (a segment a frame):
    stopped after one segment (--limit 1), then run again over the same
    directory, which resumes the rest; its stream must equal an
    uninterrupted run's."""
    import io
    import tempfile

    from rav1e_tpu_torch.__main__ import main as cli_main
    from rav1e_tpu_torch.obu.ivf import read_ivf
    from rav1e_tpu_torch.utils.content import make_frames
    from rav1e_tpu_torch.utils.frame import write_y4m_frame, write_y4m_header

    w, h = RESUME_SIZE
    with tempfile.TemporaryDirectory() as d:
        src = str(Path(d) / "in.y4m")
        with open(src, "wb") as fh:
            write_y4m_header(fh, w, h)
            for f in make_frames(w, h, RESUME_FRAMES, seed=5):
                write_y4m_frame(fh, f)

        def run(name, shards, *extra):
            out = str(Path(d) / f"{name}.ivf")
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                rc = cli_main([src, "-o", out, "--keyint", "1",
                               "--shard-dir", str(Path(d) / shards),
                               "--device", device, *extra])
            if rc != 0:
                raise RuntimeError(f"the CLI returned {rc}")
            with open(out, "rb") as fh:
                return [pkt for _pts, pkt in read_ivf(fh)], log.getvalue()

        t0 = time.perf_counter()
        first, log1 = run("stopped", "part", "--limit", "1")
        resumed, log2 = run("resumed", "part")
        whole, log3 = run("whole", "full")
        secs = time.perf_counter() - t0
    if len(first) != 1 or resumed != whole or len(whole) != RESUME_FRAMES:
        raise RuntimeError(f"resume: {len(first)} packet(s) before the stop, "
                           f"resumed stream equal: {resumed == whole}")
    if f"({1} resumed)" not in log2:
        raise RuntimeError(f"the resumed run printed {log2!r}")
    return {"frames": RESUME_FRAMES, "size": f"{w}x{h}",
            "stopped_after_segments": len(first), "resumed_equal_whole": True,
            "cli_lines": [log1.strip(), log2.strip(), log3.strip()],
            "bytes": sum(map(len, whole)), "seconds": secs, "card": card}


def tiles(card: str) -> list:
    """The tile route (phase 13 of the module docstring).  Returns the
    kernels JSON entries of its largest K1, K2 and K3 calls."""
    import numpy as np
    import torch

    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.utils import recon_check
    from rav1e_tpu_torch.utils.content import make_frames
    from rav1e_tpu_torch.utils.stream_check import recon_digest

    frames = make_frames(*TILE_SIZE, TILE_FRAMES)
    # EncoderConfig's default tune (psychovisual): the route's lanes carry
    # the lambda map, so its bytes must be the single-device encode's
    kw = dict(check=True, size=TILE_SIZE, tile_cols=TILE_COLS)
    cap = Capture()
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        data, recon, fes = encode(frames, threads=TILE_COLS, **kw)
        torch.cuda.synchronize()
    finally:
        cap.restore()
    t_enc = time.perf_counter() - t0
    counts = dict(kernels.COUNTS)
    routes, stages = encode.key_routes, encode.stages
    print(json.dumps({"tiles_path_launches": counts, "key_routes": routes,
                      "card": card}))
    print(json.dumps({"tiles_encode": {
        "frames": TILE_FRAMES, "size": "%dx%d" % TILE_SIZE,
        "tile_cols": TILE_COLS, "threads": TILE_COLS, "seconds": t_enc,
        "fps": TILE_FRAMES / t_enc, "stages_s": stages, "card": card}}))
    missing = [k for k in TILE_LAUNCHED if counts[k] == 0]
    ran = [k for k in TILE_IDLE if counts[k]]
    if (missing or ran or counts["wavefront_tiles"] != TILE_FRAMES
            or routes != {"tiles": TILE_FRAMES} or len(fes) != TILE_FRAMES):
        raise RuntimeError(f"tile route: not launched {missing}, launched "
                           f"off the path {ran}, routes {routes}, "
                           f"wavefront_tiles {counts['wavefront_tiles']}")
    print(json.dumps({"tiles_bound_ms_per_frame": {
        k: v / TILE_FRAMES for k, v in cap.bounds.items()}, "card": card}))
    t1 = time.perf_counter()
    single, single_recon, single_fes = encode(frames, **kw)
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t1
    if encode.key_routes != {"single": TILE_FRAMES}:
        raise RuntimeError(f"threads=0 took {encode.key_routes}")
    sbs = 0
    for f, (fe, fs) in enumerate(zip(fes, single_fes)):
        dev = fs._chk_wf.geom.device_sb
        if not (dev == fe._chk_wf.geom.device_sb).all():
            raise RuntimeError(f"frame {f}: the routes' device SBs differ")
        for r, c in zip(*dev.nonzero()):
            if _records(fe._chk_wf, r, c) != _records(fs._chk_wf, r, c):
                raise RuntimeError(f"frame {f} SB ({r}, {c}): the route's "
                                   "records differ from the single pass's")
            sbs += 1
    same_recon = all(np.array_equal(np.asarray(a[p]), np.asarray(b[p]))
                     for a, b in zip(recon, single_recon) for p in range(3))
    if single != data or not same_recon:
        raise RuntimeError("the route's bytes or recon differ from the "
                           "single-device encode's")
    print(json.dumps({"tiles_vs_single": {
        "bytes_equal": True, "recon_equal": True, "sb_records_equal": sbs,
        "single_seconds": t_single, "single_fps": TILE_FRAMES / t_single,
        "single_stages_s": encode.stages, "card": card}}))
    renames = {k: k + "_tiles" for k in TILE_KERNELS}
    results = check_leaf_kernels(
        {renames[k]: cap.calls[k] for k in TILE_KERNELS},
        {renames[k]: cap.ncalls[k] for k in TILE_KERNELS},
        {renames[k]: counts[k] for k in TILE_KERNELS}, TILE_FRAMES,
        keys=tuple(renames.values()))
    for r in results:
        r["path"] = "rav1e_tpu/parallel/tiles.py:78 run_wavefront_sharded"
    check_modes(cap.calls, "tiles", card)
    check_every(cap, "tiles", card)
    t2 = time.perf_counter()
    edges = sum(rederive_tile_edges(fe) for fe in fes)
    if not recon_check.filters_match(fes[0], fes[0]._chk_prefilter,
                                     recon[0]):
        raise RuntimeError("the route's frame 0: the numpy filters over its "
                           "pre-filter frame differ from the output")
    digests = [recon_digest(r) for r in recon]
    print(json.dumps({"tiles_output": {
        "dav1d": check_decode(data, recon), "tile_edge_sbs_rederived": edges,
        "filter_chain_np_frames": 1, "recon_sha256": digests},
        "bytes": sum(map(len, data)), "check_s": time.perf_counter() - t2}))
    save_stream("tiles", data, {"recon_sha256": digests}, size=TILE_SIZE)
    print(json.dumps({"tiles_serial_pass": {
        "route": serial_tile_pass(fes[-1], card),
        "single": serial_pass(single_fes[-1], card)}}))
    print(json.dumps({"tiles_resume": resume_on_card(card)}))
    # phase 14 reads frame 0 of this phase
    tiles.first = (frames[0], data[0], recon[0], fes[0])
    return results


# phase 14, the multi-device half of parallel/: deblock_sharded over 4
# shards (luma slabs of 640 columns on a 2560-wide frame, chroma of 320)
# and the tile route over 2 slots
MULTI_SHARDS, MULTI_SLOTS = 4, 2
MULTI_BD = 10  # the seeded plane's bit depth on the path
MULTI_BD_CHECKED = 12  # and a seeded plane's held to the same checks


def _deblock_work(cases, info) -> tuple:
    """(bytes, operations) of deblocking each (plane, plane_idx, sub, bd)
    of `cases` whole: each sample read and written once as int32; of the
    maps, the entries K4 reads (_k4_reads): txw and bx in the vertical
    pass, txh and by in the horizontal one, skip where either reads it
    (a 4:2:0 chroma pass reads only every other mi line); ~100
    operations a line and edge in each direction."""
    nbytes = ops = 0
    grid = info.skip.shape
    for plane, _p, s, _bd in cases:
        h, w = plane.shape
        txv, bpv = _k4_reads(h, w, s, s, grid)
        txh, bph = (m.T for m in _k4_reads(w, h, s, s, grid[::-1]))
        nbytes += (plane.size * 8 + 4 * int(txv.sum() + bpv.sum()
                                            + txh.sum() + bph.sum())
                   + int((txv | txh).sum()))
        ops += plane.size * 100 / 4 * 2
    return nbytes, ops


def flat_plane(rng, h: int, w: int, bd: int):
    """Flat 8x8 patches with +-1 (at 8 bits) noise, so that most edges
    pass the filter masks (uniform noise passes none)."""
    import numpy as np

    top = 1 << bd
    base = np.kron(rng.integers(top // 4, 3 * top // 4, (h // 8 + 1,
                                                         w // 8 + 1)),
                   np.ones((8, 8), np.int64))[:h, :w]
    step = 1 << (bd - 8)
    return np.clip(base + step * rng.integers(-1, 2, (h, w)), 0,
                   top - 1).astype(np.int32)


K6_EDGE_SIZE = (1080, 1000)  # height 56 mod 64, width 40 mod 64
K6_EDGE_BDS = (8, 10, 12)
K6_EDGE_STRENGTHS = (2, 2, 1, 0)  # y pri, y sec, uv pri, uv sec: two
#                                   applies (no table pair joins them)


def k6_edges(card: str, device: str = "cuda", size=K6_EDGE_SIZE) -> list:
    """Phase 17: K6 against cdef_filter_plain on seeded planes of `size`
    (partial superblocks on the bottom row and the right column) at 8, 10
    and 12 bits, each with a random, an all-inactive and an all-active
    block map: the search's SSE and the apply of random candidate pairs
    identical; the apply of each candidate pair for every superblock (the
    fixed strengths) identical; and cdef_frame_device with
    K6_EDGE_STRENGTHS on the card equal to the same call on the CPU (the
    plain versions).  Prints what it checked; returns no kernels entry
    (K6's is the main path's)."""
    import numpy as np
    import torch

    from rav1e_tpu_torch.ops import cdef

    rng = np.random.default_rng(20261018)
    h, w = size
    nsb = (-(-h // 64), -(-w // 64))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    out = {"size": [h, w], "checked": 0, "card": card}
    for bd in K6_EDGE_BDS:
        dims = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
        src = [flat_plane(rng, hh, ww, bd) for hh, ww in dims]
        rec = [np.clip(p + rng.normal(0, 3 << (bd - 8), p.shape).round(), 0,
                       (1 << bd) - 1).astype(np.int32) for p in src]
        dirs, var = cdef.cdef_dir(t(rec[0]), bd)
        damping = 4 + bd - 8
        for kind, act in (
                ("random", rng.random((h // 8, w // 8)) < 0.7),
                ("none", np.zeros((h // 8, w // 8), bool)),
                ("all", np.ones((h // 8, w // 8), bool))):
            args = (*map(t, rec), *map(t, src), dirs, var, t(act), damping)
            what = f"cdef_filter {bd}-bit {h}x{w}, {kind} blocks"
            _same(cdef.cdef_filter(*args, cdef.SEARCH, None, bd),
                  cdef.cdef_filter_plain(*args, cdef.SEARCH, None, bd),
                  what + " (search)")
            idx = t(rng.integers(0, 8, nsb).astype(np.int32))
            _same(cdef.cdef_filter(*args, cdef.APPLY, idx, bd),
                  cdef.cdef_filter_plain(*args, cdef.APPLY, idx, bd),
                  what + " (apply)")
            out["checked"] += 2
        for k in range(8):
            idx = t(np.full(nsb, k, np.int32))
            _same(cdef.cdef_filter(*args, cdef.APPLY, idx, bd),
                  cdef.cdef_filter_plain(*args, cdef.APPLY, idx, bd),
                  f"cdef_filter {bd}-bit, pair {k} for every superblock")
            out["checked"] += 1
        skip = rng.random((h // 4, w // 4)) < 0.3
        got = [[p.copy() for p in rec] for _ in range(2)]
        for planes, dev in zip(got, (device, "cpu")):
            cdef.cdef_frame_device(planes, skip, *K6_EDGE_STRENGTHS, 4, bd, w,
                                   h, device=dev)
        if not all(np.array_equal(a, b) for a, b in zip(*got)) or all(
                np.array_equal(a, b) for a, b in zip(got[0], rec)):
            raise RuntimeError(f"cdef_frame_device at {bd} bits differs "
                               "from its plain route or filtered nothing")
        out["checked"] += 1
    print(json.dumps({"k6_edges": out}))
    return []


def multidevice(card: str, frame, packet, frame_recon, fe,
                device: str = "cuda") -> list:
    """The multi-device path (phase 14 of the module docstring) on phase
    13's frame 0 (`frame`, its packet, recon and encoder); with device
    "cpu" every slot is the CPU.  Returns the kernels JSON entries of K4
    on the sharded path."""
    import numpy as np
    import torch

    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.ops import deblock as db
    from rav1e_tpu_torch.ops import deblock_np as dnp
    from rav1e_tpu_torch.parallel import mesh as tmesh
    from rav1e_tpu_torch.parallel import tiles as ttiles
    from rav1e_tpu_torch.parallel.dryrun import default_slots, dryrun_multidevice

    t_phase = time.perf_counter()
    slots_of = default_slots if device == "cuda" else lambda n: [device] * n
    mesh = tmesh.make_mesh(MULTI_SHARDS, devices=slots_of(MULTI_SHARDS))
    check_us = guard_us = None
    if device == "cuda":
        # on the host's clock: the current-device check every launch makes
        # (kernels.launch), and the device guard it enters for a tensor on
        # another device than the current one
        on = torch.device("cuda", 0)
        t0 = time.perf_counter()
        for _ in range(10000):
            torch.cuda.current_device()
        check_us = (time.perf_counter() - t0) / 10000 * 1e6
        t0 = time.perf_counter()
        for _ in range(10000):
            with torch.cuda.device(on):
                pass
        guard_us = (time.perf_counter() - t0) / 10000 * 1e6
    print(json.dumps({"multidevice_slots": {
        "device_count": torch.cuda.device_count(),
        "slots": [str(d) for d in mesh.slots],
        "shard_devices": [str(d) for d in mesh.devices],
        "distinct_gpus": len({d for d in mesh.slots if d.type == "cuda"}),
        "device_check_us": check_us, "device_guard_us": guard_us,
        "card": card}}))
    info, levels, sharp = fe.db_info, fe.lf_levels, fe.lf_sharpness
    if not (levels[0] and levels[1]):
        raise RuntimeError(f"phase 13's frame 0 has luma levels {levels}")
    cases = [(fe._chk_prefilter[p], p, 0 if p == 0 else 1, 8)
             for p in range(3)]
    h, w = cases[0][0].shape
    cases += [(flat_plane(np.random.default_rng(14), h, w, bd), 0, 0, bd)
              for bd in (MULTI_BD, MULTI_BD_CHECKED)]

    def sharded(case):
        plane, p, s, bd = case
        return ttiles.deblock_sharded(mesh, plane, info, levels, sharp, p, s,
                                      s, bd, plane.shape[1], plane.shape[0])

    # the phase's path: the frame's three planes, then the 10-bit plane
    kernels.reset_counts()
    t0 = time.perf_counter()
    outs = [sharded(c) for c in cases[:3]]
    launches8 = kernels.COUNTS["deblock"]
    outs.append(sharded(cases[3]))
    launches10 = kernels.COUNTS["deblock"] - launches8
    t_path = time.perf_counter() - t0
    if device == "cuda" and not (launches8 and launches10):
        raise RuntimeError(f"K4 launches on the sharded path: {launches8}, "
                           f"{launches10}")
    outs.append(sharded(cases[4]))

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    maps = [t(a) for a in (info.txw, info.txh, info.bx, info.by, info.skip)]

    def whole(xs):
        """K4's single-device deblock_plane of each (plane on the card,
        case)."""
        return [db.deblock_plane(x, *maps, p, s, s,
                                 *db.plane_lims(levels, sharp, p, bd), bd)
                for x, (_, p, s, bd) in xs]

    def plain(xs):
        """The same two directions through K4's plain version,
        deblock_pass_plain, on the same card tensors."""
        txw, txh, bx, by, skip = maps
        res = []
        for x, (_, p, s, bd) in xs:
            lv, lh = db.plane_lims(levels, sharp, p, bd)
            x = db.deblock_pass_plain(x, *lv[:3], bd, p, txw >> s, bx >> s,
                                      skip, s, s)
            res.append(db.deblock_pass_plain(
                x.t(), *lh[:3], bd, p, (txh >> s).t(), (by >> s).t(),
                skip.t(), s, s).t())
        return res

    errs = []
    for case, out in zip(cases, outs):
        plane, p, s, bd = case
        xs = [(t(plane), case)]
        ref = plane.copy()
        dnp.deblock_plane(ref, info, p, levels, sharp, s, s, bd,
                          plane.shape[1], plane.shape[0])
        if np.array_equal(ref, plane):
            raise RuntimeError(f"plane {p} at {bd} bits: the deblock "
                               "filtered nothing")
        ref = t(ref)
        errs.append(max(int((t(out) - ref).abs().max()),
                        int((whole(xs)[0] - ref).abs().max()),
                        int((plain(xs)[0] - ref).abs().max())))
    if any(errs):
        raise RuntimeError(f"deblock_sharded, K4's deblock_plane, its plain "
                           f"version and deblock_np differ: {errs}")

    report = {"deblock_sharded_launches": launches8,
              "deblock_sharded_10bit_launches": launches10,
              "max_abs_err": errs, "path_s": t_path, "card": card}
    timing = {}
    for name, group in (("frame_8bit", cases[:3]), ("plane_10bit",
                                                    cases[3:4])):
        xs = [(t(c[0]), c) for c in group]
        work = _deblock_work(group, info)
        timing[name] = (work, {
            "sharded_ms": cuda_ms(lambda: [sharded(c) for c in group],
                                  reps=5),
            "single_ms": cuda_ms(lambda: whole(xs), reps=10),
            "plain_ms": cuda_ms(lambda: plain(xs), reps=2),
            "bound_ms": bound_ms(*work)})
        report[name] = timing[name][1]
    print(json.dumps({"multidevice_deblock": report}))
    results = []
    entry = make_entry(results, {"deblock_sharded": launches8,
                                 "deblock_sharded_10bit": launches10}, 1)
    for name, key, err in (("deblock_sharded", "frame_8bit", max(errs[:3])),
                           ("deblock_sharded_10bit", "plane_10bit",
                            errs[3])):
        work, tm = timing[key]
        entry(name, "rav1e_tpu_torch/csrc/deblock.cu",
              "rav1e_tpu/parallel/tiles.py:153", err, tm["sharded_ms"],
              tm["plain_ms"], work)
    for r in results:
        r["path"] = "rav1e_tpu/parallel/tiles.py:153 deblock_sharded"

    # frame 0 through the Context with its mesh on MULTI_SLOTS slots
    route_slots = [torch.device(d) for d in slots_of(MULTI_SLOTS)]
    orig = tmesh.slots_for
    tmesh.slots_for = lambda _device, _n, _count: route_slots
    kernels.reset_counts()
    t1 = time.perf_counter()
    try:
        data, recon, fes = encode([frame], check=True, device=device,
                                  size=(w, h), tile_cols=TILE_COLS,
                                  threads=TILE_COLS)
        torch.cuda.synchronize()
    finally:
        tmesh.slots_for = orig
    t_route = time.perf_counter() - t1
    counts = dict(kernels.COUNTS)
    slots = fes[0].wavefront_mesh.slots
    if (encode.key_routes != {"tiles": 1} or list(slots) != route_slots
            or counts["wavefront_tiles"] != (device == "cuda")):
        raise RuntimeError(f"the {MULTI_SLOTS}-slot route: routes "
                           f"{encode.key_routes}, slots {slots}, "
                           f"wavefront_tiles {counts['wavefront_tiles']}")
    dev_sb = fe._chk_wf.geom.device_sb
    sbs = 0
    for r, c in zip(*dev_sb.nonzero()):
        if _records(fes[0]._chk_wf, r, c) != _records(fe._chk_wf, r, c):
            raise RuntimeError(f"SB ({r}, {c}): the {MULTI_SLOTS}-slot "
                               "route's records differ from one slot's")
        sbs += 1
    if data != [packet] or not all(
            np.array_equal(np.asarray(recon[0][p]),
                           np.asarray(frame_recon[p])) for p in range(3)):
        raise RuntimeError(f"the {MULTI_SLOTS}-slot route's bytes or recon "
                           "differ from one slot's")
    print(json.dumps({"multidevice_route": {
        "slots": [str(d) for d in slots], "bytes_equal": True,
        "recon_equal": True, "sb_records_equal": sbs, "seconds": t_route,
        "launches": {k: counts[k] for k in TILE_KERNELS}, "card": card}}))
    line = dryrun_multidevice(
        MULTI_SHARDS, None if device == "cuda" else [device] * MULTI_SHARDS)
    print(json.dumps({"multidevice_dryrun": line,
                      "phase_s": time.perf_counter() - t_phase,
                      "card": card}))
    return results


# phase 15: the LR decision of a chain without its fused stage (row 9b)
# and the source-edge analysis functions (rows 10h', 11', 17-19)
LR_UNFUSED_FRAMES = 2  # 1080p key frames with RAV1E_TPU_LR_FUSE=0
ANALYSIS_KERNELS = ("mode_sad", "dr_predict", "build_edges")
ANALYSIS_SHARDS = 4
ANALYSIS_QIDX = 100
DR_SHAPES = ((8, 8), (16, 16), (32, 32), (8, 16), (16, 8))  # (w, h)
DR_LANES = 64  # lanes an angle: 3,584 a shape
STACK_LANES = 1024
EDGE_LANES = 4096
PUT_BLOCKS = 1024
# operations a sample of each CANDIDATES prediction in K12 (DC, V, H come
# from the edges; SMOOTH 4 multiplies, 5 adds, a shift; PAETH 3
# differences, 3 absolutes, 2 compares and the pick; a zone-2 angle its
# position, shift, mask, two clamps, two multiplies, two adds, a shift)
MODE_SAD_PRED_OPS = (0, 0, 0, 12, 6, 6, 10, 12, 12, 12)
DR_OPS = 12  # a K13 sample: position, shift, mask, clamps, 2 taps, round
EDGE_OPS = 12  # a K14 edge index: the clamps, the reach and the selects


def _mode_sad_work(B, hh, ww, n, count) -> tuple:
    """K12: the int32 planes read once, two int32 words a block out; each
    sample's predictions and their SAD terms (SAD_OPS) per candidate."""
    samples = B * hh * ww
    return (samples * 4 + samples // (n * n) * 8,
            samples * (sum(MODE_SAD_PRED_OPS[:count]) + count * SAD_OPS))


def _dr_work(B, w, h) -> tuple:
    """K13: both int32 edge vectors and the angle read once, the int32
    prediction written once."""
    return (B * (2 * (1 + w + h) + 1) * 4 + B * w * h * 4,
            B * w * h * DR_OPS)


def _edges_work(B, w, h) -> tuple:
    """K14: six int32 words a lane in, and at each edge index the two
    plane samples it reads and the two int32 samples it writes."""
    n = 1 + w + h
    return B * 6 * 4 + B * n * 16, B * n * EDGE_OPS


def analysis(card: str, key_fps: float, device: str = "cuda") -> list:
    """Phase 15 of the module docstring.  key_fps: the fused route's timed
    speed-6 key-frame rate (phase 7).  Returns the kernels JSON entries of
    K8 on the unfused LR route, K12, K13, K14 and K9 through
    put_single_batch."""
    import os

    import numpy as np
    import torch

    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.models import device_pipeline as dp
    from rav1e_tpu_torch.ops import intra, lrf, mc
    from rav1e_tpu_torch.parallel import mesh as tmesh
    from rav1e_tpu_torch.parallel.dryrun import default_slots
    from rav1e_tpu_torch.utils.content import make_frames, make_planes
    from rav1e_tpu_torch.utils.stream_check import recon_digest

    t_phase = time.perf_counter()
    results = []

    # -- row 9b: speed-6 key frames with the fused LR stage switched off
    frames = make_frames(W, H, LR_UNFUSED_FRAMES)
    cap = Capture(keep=("wiener_lr",))
    decided = []
    orig_decide = lrf.lr_decide_device

    def decide(fe, taps_y, taps_c):
        res = orig_decide(fe, taps_y, taps_c)
        decided.append(None if res is None else
                       {p: int(c.sum()) for p, c in res[1].items()})
        return res

    lrf.lr_decide_device = decide
    prev = os.environ.get("RAV1E_TPU_LR_FUSE")
    os.environ["RAV1E_TPU_LR_FUSE"] = "0"
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        data, recon, _ = encode(frames, check=False, device=device)
        torch.cuda.synchronize()
    finally:
        if prev is None:
            os.environ.pop("RAV1E_TPU_LR_FUSE")
        else:
            os.environ["RAV1E_TPU_LR_FUSE"] = prev
        lrf.lr_decide_device = orig_decide
        cap.restore()
    t_enc = time.perf_counter() - t0
    counts = dict(kernels.COUNTS)
    check_every(cap, "lr_unfused", card)
    lr_calls = [(a, k, out) for a, k, out in cap.every["wiener_lr"]
                if k.get("count") == "wiener_lr_decide"]
    if (len(decided) != len(frames) or None in decided
            or len(lr_calls) != 3 * len(frames)):
        raise RuntimeError(f"the unfused LR route: decisions {decided}, "
                           f"{len(lr_calls)} K8 calls for {len(frames)} "
                           "frames (3 a frame)")
    if device == "cuda" and (counts["wiener_lr_decide"] != 3 * len(frames)
                             or counts["wiener_lr"] or counts["wiener_solve"]):
        raise RuntimeError(f"the unfused LR route's launches: {counts}")
    lr_errs = []
    for a, _k, out in lr_calls:
        ref = lrf.wiener_lr_plain(*a[:10])
        lr_errs.append(max(int((out[0] - ref[0]).abs().max()),
                           int((out[1] != ref[1]).sum())))
    if any(lr_errs):
        raise RuntimeError(f"wiener_lr_decide differs from wiener_lr_plain: "
                           f"{lr_errs}")
    digests = [recon_digest(r) for r in recon]
    save_stream("lr_unfused", data, {"recon_sha256": digests})
    a, k, _ = max(lr_calls, key=lambda c: c[0][8] * c[0][9])
    lr_work = _wiener_lr_work(a, k)
    lr_t = {"ms": cuda_ms(lambda: lrf.wiener_lr(*a, **k)),
            "plain_ms": cuda_ms(lambda: lrf.wiener_lr_plain(*a[:10]),
                                reps=3)}
    print(json.dumps({"lr_unfused": {
        "frames": len(frames), "seconds": t_enc,
        "fps": len(frames) / t_enc, "fused_timed_fps": key_fps,
        "wiener_units_by_plane": decided,
        "wiener_lr_decide_launches": counts["wiener_lr_decide"],
        "max_abs_err": lr_errs, "decode": check_decode(data, recon),
        "recon_sha256": digests, "bytes": sum(map(len, data)),
        "card": card}}))
    entry = make_entry(results, {"wiener_lr_decide":
                                 counts["wiener_lr_decide"]}, len(frames))
    entry("wiener_lr_decide", "rav1e_tpu_torch/csrc/wiener_lr.cu",
          "rav1e_tpu/ops/lrf_jax.py:115", max(lr_errs), lr_t["ms"],
          lr_t["plain_ms"], lr_work)

    # -- K12: the SAD mode maps of a 1080p bench luma plane padded to
    # whole superblocks, its superblocks' step, and both over slots
    y = make_planes(W, H, 1)[0][0].astype(np.int32)
    hp, wp = (H + 63) & ~63, (W + 63) & ~63
    yp = np.pad(y, ((0, hp - H), (0, wp - W)), mode="edge")
    yt = torch.as_tensor(yp, device=device)
    sbs = yt.reshape(hp // 64, 64, wp // 64, 64).transpose(1, 2).reshape(
        -1, 64, 64).contiguous()
    slots = (default_slots(ANALYSIS_SHARDS) if device == "cuda"
             else [device] * ANALYSIS_SHARDS)
    mesh = tmesh.make_mesh(ANALYSIS_SHARDS, devices=slots)
    kernels.reset_counts()
    maps = dp.frame_mode_maps(yp, device=device)
    sharded = {n: dp.sharded_mode_analysis(mesh, yt, n) for n in (32, 16)}
    torch.cuda.synchronize()
    maps_launches = kernels.COUNTS["mode_sad"]
    step = dp.intra_analysis_step(sbs, ANALYSIS_QIDX)
    sharded_step = dp.sharded_intra_analysis(mesh, sbs, ANALYSIS_QIDX)
    torch.cuda.synchronize()
    step_launches = kernels.COUNTS["mode_sad"] - maps_launches
    if device == "cuda" and not (maps_launches and step_launches):
        raise RuntimeError(f"K12 launches: maps {maps_launches}, step "
                           f"{step_launches}")
    ids = torch.as_tensor(dp.CANDIDATES, dtype=torch.int32, device=device)
    sad_errs = {}
    for n in (32, 16):
        idx, sad = dp.mode_sad_plain(yt[None], n)
        ref = (ids[idx[0].long()].cpu().numpy(), sad[0].cpu().numpy())
        sad_errs[f"frame_n{n}"] = sum(
            int((np.asarray(g) != r).sum()) for g, r in zip(maps[n], ref))
        sad_errs[f"sharded_n{n}"] = sum(
            int((g.cpu().numpy() != r).sum()) for g, r in zip(sharded[n], ref))
    bias = 2 + (ANALYSIS_QIDX >> 5)
    step_ref = dp.mode_sad_plain(sbs, 8, 3)[1] + bias
    sad_errs["step"] = int((step != step_ref).sum())
    sad_errs["sharded_step"] = int((sharded_step.to(step_ref.device)
                                    != step_ref).sum())
    if any(sad_errs.values()):
        raise RuntimeError(f"K12 differs from its plain version: {sad_errs}")
    yb = yt[None]
    sad_t = {"ms": cuda_ms(lambda: dp.mode_sad(yb, 16)),
             "plain_ms": cuda_ms(lambda: dp.mode_sad_plain(yb, 16), reps=3),
             "sb_ms": cuda_ms(lambda: dp.mode_sad(sbs, 8, 3)),
             "sb_plain_ms": cuda_ms(lambda: dp.mode_sad_plain(sbs, 8, 3),
                                    reps=3),
             "sharded_ms": cuda_ms(
                 lambda: dp.sharded_mode_analysis(mesh, yt, 16), reps=5)}
    modes = np.bincount(maps[16][0].ravel(), minlength=13)
    print(json.dumps({"mode_analysis": {
        "plane": f"{wp}x{hp}", "superblocks": int(sbs.shape[0]),
        "slots": [str(d) for d in mesh.slots],
        "maps_launches": maps_launches, "step_launches": step_launches,
        "mismatches": sad_errs, "modes_n16": modes.tolist(), **sad_t,
        "card": card}}))
    entry = make_entry(results, {"mode_sad": maps_launches,
                                 "mode_sad_sb": step_launches}, 1)
    entry("mode_sad", "rav1e_tpu_torch/csrc/mode_sad.cu",
          "rav1e_tpu/models/device_pipeline.py:118", 0, sad_t["ms"],
          sad_t["plain_ms"], _mode_sad_work(1, hp, wp, 16, 10))
    entry("mode_sad_sb", "rav1e_tpu_torch/csrc/mode_sad.cu",
          "rav1e_tpu/models/device_pipeline.py:351", 0, sad_t["sb_ms"],
          sad_t["sb_plain_ms"], _mode_sad_work(sbs.shape[0], 64, 64, 8, 3))

    # -- K13: every directional angle, and the 13-mode stack over K1 + K13
    rng = np.random.default_rng(15)
    t = lambda v: torch.as_tensor(np.ascontiguousarray(v), device=device)

    def edges(B, w, h):
        above = rng.integers(0, 256, (B, 1 + w + h)).astype(np.int32)
        left = rng.integers(0, 256, (B, 1 + w + h)).astype(np.int32)
        left[:, 0] = above[:, 0]
        return t(above), t(left)

    angles = intra.DIR_ANGLES.reshape(-1)
    dr_args = [(*edges(len(angles) * DR_LANES, w, h),
                t(np.tile(angles, DR_LANES).astype(np.int32)), w, h)
               for w, h in DR_SHAPES]
    stack_args = [(*edges(STACK_LANES, n, n), n, n,
                   t(rng.random(STACK_LANES) < 0.7),
                   t(rng.random(STACK_LANES) < 0.7)) for n in (4, 8, 16, 32)]
    kernels.reset_counts()
    dr_out = [intra.dr_predict_batch(*a) for a in dr_args]
    stack_out = [intra.predict_stack(*a) for a in stack_args]
    torch.cuda.synchronize()
    dr_launches = kernels.COUNTS["dr_predict"]
    if device == "cuda" and dr_launches != len(dr_args) + len(stack_args):
        raise RuntimeError(f"K13 launches: {dr_launches}")

    def stack_plain(above, left, w, h, ha, hl):
        nd = intra.intra_pred_plain(above, left, ha, hl, w, False)
        out = torch.empty((above.shape[0], 13, h, w), dtype=torch.int32,
                          device=above.device)
        for ch, m in enumerate((intra.DC, intra.V, intra.H, intra.SMOOTH,
                                intra.SMOOTH_V, intra.SMOOTH_H,
                                intra.PAETH)):
            out[:, m] = nd[:, ch]
        for m in intra.STACK_DIRS:
            ang = torch.full((above.shape[0],), intra.ip.MODE_ANGLE[m],
                             dtype=torch.int32, device=above.device)
            out[:, m] = intra.dr_predict_plain(above, left, ang, w, h)
        return out

    dr_errs = [int((o - intra.dr_predict_plain(*a)).abs().max())
               for a, o in zip(dr_args, dr_out)]
    stack_errs = [int((o - stack_plain(*a)).abs().max())
                  for a, o in zip(stack_args, stack_out)]
    if any(dr_errs) or any(stack_errs):
        raise RuntimeError(f"K13 differs from its plain version: {dr_errs}, "
                           f"predict_stack {stack_errs}")
    big = dr_args[DR_SHAPES.index((32, 32))]
    dr_t = {"ms": cuda_ms(lambda: intra.dr_predict_batch(*big)),
            "plain_ms": cuda_ms(lambda: intra.dr_predict_plain(*big), reps=3),
            "stack_n32_ms": cuda_ms(lambda: intra.predict_stack(
                *stack_args[-1])),
            "stack_n32_plain_ms": cuda_ms(lambda: stack_plain(
                *stack_args[-1]), reps=3),
            # the (B, 13, 32, 32) int32 stack written, both edges read
            "stack_n32_bound_ms": bound_ms(
                STACK_LANES * (13 * 32 * 32 + 2 * 65) * 4 + STACK_LANES * 2,
                STACK_LANES * 13 * 32 * 32 * DR_OPS)}
    print(json.dumps({"dr_predict": {
        "shapes": [f"{w}x{h}" for w, h in DR_SHAPES],
        "lanes": len(angles) * DR_LANES, "launches": dr_launches,
        "max_abs_err": dr_errs, "predict_stack_max_abs_err": stack_errs,
        **dr_t, "card": card}}))
    entry = make_entry(results, {"dr_predict": dr_launches}, 1)
    entry("dr_predict", "rav1e_tpu_torch/csrc/dr_predict.cu",
          "rav1e_tpu/ops/intra_jax.py:144", max(dr_errs + stack_errs),
          dr_t["ms"], dr_t["plain_ms"], _dr_work(big[0].shape[0], 32, 32))

    # -- K14: the edges of blocks of every availability over the plane
    w = h = 16
    B = EDGE_LANES
    ys = (rng.integers(0, H // h, B) * h).astype(np.int32)
    xs = (rng.integers(0, W // w, B) * w).astype(np.int32)
    ys[:4], xs[:4] = (0, 0, H - h, H - h), (0, W - w, 0, W - w)
    edge_args = (t(y), t(ys), t(xs), w, h, t(np.arange(B) % 2 == 0),
                 t(np.arange(B) % 4 < 2),
                 t((rng.integers(0, 3, B) * (w // 2)).astype(np.int32)),
                 t((rng.integers(0, 3, B) * (h // 2)).astype(np.int32)),
                 W - 1, H - 1, 8)
    kernels.reset_counts()
    got = intra.build_edges_batch(*edge_args)
    torch.cuda.synchronize()
    edge_launches = kernels.COUNTS["build_edges"]
    if device == "cuda" and edge_launches != 1:
        raise RuntimeError(f"K14 launches: {edge_launches}")
    ref = intra.build_edges_plain(*edge_args)
    edge_err = max(int((g - r).abs().max()) for g, r in zip(got, ref))
    if edge_err:
        raise RuntimeError(f"K14 differs from its plain version: {edge_err}")
    edge_t = {"ms": cuda_ms(lambda: intra.build_edges_batch(*edge_args)),
              "plain_ms": cuda_ms(lambda: intra.build_edges_plain(*edge_args),
                                  reps=3)}
    print(json.dumps({"build_edges": {"lanes": B, "launches": edge_launches,
                                      "max_abs_err": edge_err, **edge_t,
                                      "card": card}}))
    entry = make_entry(results, {"build_edges": edge_launches}, 1)
    entry("build_edges", "rav1e_tpu_torch/csrc/build_edges.cu",
          "rav1e_tpu/ops/intra_jax.py:44", edge_err, edge_t["ms"],
          edge_t["plain_ms"], _edges_work(B, w, h))

    # -- row 10h': put_single_batch (K9) on luma, 4:2:0 chroma, 10 bits
    y10 = make_planes(W, H, 1, bit_depth=10)[0][0]
    u8 = make_planes(W, H, 1)[0][1]
    put_cases = (("luma", y, 0, 8, 0, 16), ("chroma420", u8, 1, 8, 0, 8),
                 ("10bit", y10, 0, 10, 2, 32))
    lim = mc.MV_LIMIT
    put_args = []
    for name, plane, sub, bd, fset, n in put_cases:
        ph, pw = plane.shape
        blocks = np.stack([rng.integers(0, pw - n + 1, PUT_BLOCKS),
                           rng.integers(0, ph - n + 1, PUT_BLOCKS)], 1)
        mvs = rng.integers(-lim, lim + 1, (PUT_BLOCKS, 2))
        put_args.append((name, (plane, blocks, mvs, n, n, sub, sub, bd,
                                fset)))
    kernels.reset_counts()
    put_out = [mc.put_single_batch(*a, device=device) for _n, a in put_args]
    torch.cuda.synchronize()
    put_launches = kernels.COUNTS["mc_pred"]
    if device == "cuda" and put_launches != len(put_args):
        raise RuntimeError(f"K9 launches through put_single_batch: "
                           f"{put_launches}")

    def put_inputs(plane, blocks, mvs, w, h, sub_x, sub_y, bd, fset):
        """put_single_batch's padded plane and lanes on the card (its
        kernel's arguments, with the plain version's int32 plane)."""
        pad = mc.pad_ref_plane(plane, mc.MC_MARGIN,
                               ((plane.shape[0] + 63) & ~63) + 64,
                               ((plane.shape[1] + 63) & ~63) + 64)
        lanes = [t(np.asarray(v, np.int32)) for v in
                 (blocks[:, 0], blocks[:, 1], mvs[:, 0], mvs[:, 1])]
        dtype = np.uint8 if bd == 8 else np.uint16
        return ((t(pad.astype(dtype)), mc.MC_MARGIN, *lanes, w, h, sub_x,
                 sub_y, bd, mc.filter_taps(fset)),
                (t(pad), mc.MC_MARGIN, *lanes, w, h, sub_x, sub_y, bd,
                 mc.filter_taps(fset)))

    put_errs = {}
    for (name, a), out in zip(put_args, put_out):
        _kern, plain = put_inputs(*a)
        put_errs[name] = int(np.abs(
            out - mc.mc_block_batch_plain(*plain).cpu().numpy()).max())
    if any(put_errs.values()):
        raise RuntimeError(f"put_single_batch differs from K9's plain "
                           f"version: {put_errs}")
    kern, plain = put_inputs(*put_args[-1][1])
    put_t = {"ms": cuda_ms(lambda: mc.mc_block_batch(*kern)),
             "plain_ms": cuda_ms(lambda: mc.mc_block_batch_plain(*plain),
                                 reps=3),
             "wrapper_ms": cuda_ms(lambda: mc.put_single_batch(
                 *put_args[-1][1], device=device), reps=3)}
    print(json.dumps({"put_single_batch": {
        "cases": [n for n, _a in put_args], "blocks": PUT_BLOCKS,
        "launches": put_launches, "max_abs_err": put_errs, **put_t,
        "card": card}}))
    entry = make_entry(results, {"mc_pred_put": put_launches}, 1)
    entry("mc_pred_put", "rav1e_tpu_torch/csrc/mc_pred.cu",
          "rav1e_tpu/ops/mc_jax.py:109", max(put_errs.values()),
          put_t["ms"], put_t["plain_ms"], _mc_work(kern, {}))
    print(json.dumps({"analysis_phase_s": time.perf_counter() - t_phase,
                      "card": card}))
    return results


SEG_SIZE = (320, 240)  # the size of tests/test_torch_inter.py's GOP
SEG_FRAMES = 3  # 1 key + 2 P frames
SEG_LAUNCHED = ("intra_pred", "fwd_txq", "inv_txfm", "mc_pred", "me_fullpel",
                "fwd_txq_thin")


def seg_gop(card: str) -> list:
    """The segmentation GOP (phase 16): SEG_FRAMES frames of SEG_SIZE in
    the mixed GOP's configuration with EncoderConfig(segmentation_aq=True),
    with the counts set to 0 before it.  The key frame codes segment ids
    and per-segment quantisers on the key pass; the P frames (to which the
    Context gives no segmentation map) take the inter wavefront, K1-K3,
    K9, K10 and K2's thinning launching.  The P frames' sampled
    superblocks re-derive and the last one's numpy filter chain gives its
    output; with --save-stream writes DIR/seg.ivf and DIR/seg_recon.json
    for utils/stream_check.py to decode.  Prints its seconds."""
    import torch

    from rav1e_tpu_torch import kernels
    from rav1e_tpu_torch.utils import recon_check
    from rav1e_tpu_torch.utils.content import make_frames
    from rav1e_tpu_torch.utils.stream_check import recon_digest

    frames = make_frames(*SEG_SIZE, SEG_FRAMES)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data, recon, fes = encode(frames, check=True, mixed=True, size=SEG_SIZE,
                              seg=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(kernels.COUNTS)
    segmented = [fe.seg_map is not None for fe in encode.all_fes]
    inter = [fe for fe in fes if fe._chk_wf.has_mv]
    missing = [k for k in SEG_LAUNCHED if counts[k] == 0]
    if (missing or encode.frame_types != ["key"] + ["inter"] * (SEG_FRAMES - 1)
            or len(inter) != SEG_FRAMES - 1 or not segmented[0]):
        raise RuntimeError(f"segmentation GOP: not launched {missing}, "
                           f"types {encode.frame_types}, {len(inter)} frames "
                           f"on the inter wavefront, segmented {segmented}")
    checked, inter_sbs = rederive_sbs(inter)
    if not recon_check.filters_match(inter[-1], inter[-1]._chk_prefilter,
                                     recon[-1]):
        raise RuntimeError("segmentation GOP: the numpy filter chain over "
                           "the last P frame differs from its output")
    digests = [recon_digest(r) for r in recon]
    save_stream("seg", data, {"recon_sha256": digests}, size=SEG_SIZE)
    print(json.dumps({"seg_gop": {
        "frames": SEG_FRAMES, "size": "%dx%d" % SEG_SIZE, "seconds": secs,
        "frame_types": encode.frame_types, "segmented": segmented,
        "dav1d": check_decode(data, recon), "sbs_rederived": checked,
        "sbs_rederived_with_inter_blocks": inter_sbs,
        "launches": {k: counts[k] for k in SEG_LAUNCHED},
        "bytes": sum(map(len, data)), "recon_sha256": digests,
        "card": card}}))
    return []


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

    t_start = t0 = time.perf_counter()
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
        # nvcc's ptxas lines of each entry function: its name, registers,
        # stack frame and spills
        info = [ln.strip() for ln in kernels.BUILD_LOGS.get(name, "").splitlines()
                if "registers" in ln or "spill" in ln
                or "Function properties" in ln]
        print(json.dumps({"ptxas": name, "info": info}))
        # K1, K3, K7, K9 and K15 keep every array in registers: no stack,
        # no spills
        if name in NO_STACK and any(
                "stack frame" in ln and not ln.startswith(
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                    "spill loads") for ln in info):
            raise RuntimeError(f"{name}: ptxas reports a stack frame or "
                               "spills")
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
    check_decide_launches(counts, cap, NFRAMES, "the main path")
    if len(fes) != NFRAMES:
        raise RuntimeError(f"{len(fes)} of {NFRAMES} frames took the "
                           "wavefront")

    print(json.dumps({"bound_ms_per_frame": {
        k: v / NFRAMES for k, v in cap.bounds.items()}, "card": card}))
    results = check_kernels(cap.calls, counts, NFRAMES)
    check_modes(cap.calls, "keyframes", card, timed=True)
    fwd_sums_only(cap.calls, card)
    t3 = time.perf_counter()
    summary = check_output(data, recon, fes, FILTER_FRAMES)
    from rav1e_tpu_torch.utils.stream_check import recon_digest

    digests = [recon_digest(r) for r in recon]
    print(json.dumps({"output": summary, "bytes": sum(map(len, data)),
                      "check_s": time.perf_counter() - t3,
                      "bottom_lr_units": bottom_lr_units(fes),
                      "recon_sha256": digests}))
    save_stream("key", data, {"recon_sha256": digests})

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
    key_fps = KEY_TIMED / t_enc
    print(json.dumps({"encode": {"frames": KEY_TIMED, "size": f"{W}x{H}",
                                 "seconds": t_enc, "fps": key_fps,
                                 "stages_s": encode.stages, "card": card}}))
    print(json.dumps({"breakdown": breakdown(frames[:BREAKDOWN_FRAMES],
                                             "--profile" in sys.argv),
                      "card": card}))
    check_every(cap, "keyframes", card)
    # each later phase's wall seconds, beside phases 1-7's together
    walls = {"phases_1_7": time.perf_counter() - t_start}
    for name, phase in (
            ("8_mixed_gop", lambda: mixed_gop(card)),
            ("9_speed5", lambda: speed5(card)),
            ("10_default_gop", lambda: default_gop(card)),
            ("11_hbd_gop", lambda: hbd_gop(card)),
            ("12_speed3", lambda: speed3(card)),
            ("13_tiles", lambda: tiles(card)),
            ("14_multidevice", lambda: multidevice(card, *tiles.first)),
            ("15_analysis", lambda: analysis(card, key_fps)),
            ("16_segmentation", lambda: seg_gop(card)),
            ("17_k6_edges", lambda: k6_edges(card))):
        t_ph = time.perf_counter()
        results += phase()
        walls[name] = time.perf_counter() - t_ph
    print(json.dumps({"phase_wall_s": walls, "card": card}))
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
