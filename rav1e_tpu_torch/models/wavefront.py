"""Wavefront device encode of key frames and P frames, in PyTorch on the GPU.

Counterpart of rav1e_tpu/models/wavefront.py: the keyframe pass, with CFL
at speed <= 5 and the 8x8 level at speed <= 3, and with inter_on the
P-frame pass of single-LAST-reference frames.  rav1e walks superblocks
serially because intra prediction consumes reconstructed neighbours and
the entropy coder is adaptive.  Here the two concerns are split:

  1. DEVICE (this module): a loop over superblock wavefronts with slope 2
     (step k processes all SBs with 2*row + col == k, so the left / above /
     above-right / below-left dependencies all land in earlier steps).
     Each step runs the full coding datapath for a batch of SBs: exact
     edge build, all intra predictors (K1), the SAD angle-delta pick, the
     13-mode tx-domain RD race and the 5-type luma tx race (K2), CFL
     against DC (K11, K2, K3) and the uv race, bit-exact inverse
     transforms (K3) and in-carry reconstruction,
     the NONE-vs-SPLIT decisions at 32 and 16 (with allow_split8 each 16
     leaf also raced against its four 8x8 leaves) and the 64x64 root
     trial.
     With inter_on, phase A runs before the scan: the full-pel motion
     search (K10), 8/8/6 motion vector candidates a block at the 64, 32
     and 16 levels, each raced through subpel MC (K9) and the forward
     transform with level-1 thinning (K2), and each level's winner coded
     on all three planes with a skip-vs-code RD; the scan then races every
     leaf's intra result against its inter winner.
  2. HOST: the adaptive MSAC entropy pass replays the device-chosen
     symbols through the C++ coder (native/block_intra.cc BlockCache) in
     decode order; reconstruction is not recomputed.

The pass takes the same packed upload vector as the JAX pass and emits the
same int16 records (1688 words per lane, 1772 with inter_on; rec_width)
that the C++ walker consumes; the JAX package's int8 transport with escape
refetch is not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rav1e_tpu_torch.models import device_pipeline as dp
from rav1e_tpu_torch.ops import intra as ij
from rav1e_tpu_torch.ops import mc
from rav1e_tpu_torch.ops import transforms as tt
from rav1e_tpu_torch.ops import transforms_np as tn
from rav1e_tpu_torch.ops.quantize_np import tx_scale

# tx-domain sse -> pixel sse for the mode-RD argmin
DIST_SCALE = 0.0164

_QOFF = ((0, 0), (0, 32), (32, 0), (32, 32))  # quadrant z-order
_SOFF = ((0, 0), (0, 16), (16, 0), (16, 16))  # 16-leaf z-order
_SOFF8 = ((0, 0), (0, 8), (8, 0), (8, 8))  # 8-leaf z-order


# ---------------------------------------------------------------------------
# host geometry: device region, wavefront schedule, decoder-availability sim
# ---------------------------------------------------------------------------


@dataclass
class WavefrontGeometry:
    """Static per-(frame size, tile grid) data for the device pass."""

    h: int  # SB-padded plane dims
    w: int
    mi_cols: int
    mi_rows: int
    steps: int
    width: int  # max wavefront width (B)
    sbr: np.ndarray  # (K, B) int32; invalid lanes point past the SB grid
    sbc: np.ndarray
    valid: np.ndarray  # (K, B) bool
    avail: np.ndarray  # (K, B, 4, 5, 4) int32: ha, hl, n_tr, n_bl
    avail8: np.ndarray  # (K, B, 4, 4, 4, 4): per (quad, 16-leaf, 8-leaf)
    allow_z1: np.ndarray  # (K, B) bool: zone-1 directional modes allowed
    device_sb: np.ndarray  # (sb_rows, sb_cols) bool over the FULL SB grid
    sb_step: np.ndarray  # (sb_rows, sb_cols) int32 -> (step, lane) packed
    sb_lane: np.ndarray

    @property
    def n_device(self) -> int:
        return int(self.device_sb.sum())


_GEOM_CACHE: dict = {}


def geometry_for(coded_w: int, coded_h: int, w: int, h: int, mi_cols: int,
                 mi_rows: int, tiles: tuple) -> WavefrontGeometry | None:
    """Build (cached) the wavefront geometry.  tiles: ((c0, r0, c1, r1), ...)
    in SB units (the host encoder's _tile_grid output).  Returns None when
    no full SB exists (host path handles everything)."""
    key = (coded_w, coded_h, w, h, tiles)
    if key in _GEOM_CACHE:
        return _GEOM_CACHE[key]
    sb_cols = (coded_w + 63) >> 6
    sb_rows = (coded_h + 63) >> 6
    dev = np.zeros((sb_rows, sb_cols), bool)
    for r in range(sb_rows):
        for c_ in range(sb_cols):
            dev[r, c_] = (r + 1) * 64 <= coded_h and (c_ + 1) * 64 <= coded_w
    if not dev.any():
        _GEOM_CACHE[key] = None
        return None
    partial_col = (sb_cols * 64) > coded_w

    # tile bounds per SB (pixel coords), raster over tiles like the encoder
    tile_of = {}
    for (c0, r0, c1, r1) in tiles:
        for r in range(r0, r1):
            for c_ in range(c0, c1):
                tile_of[(r, c_)] = (c0 * 64, r0 * 64,
                                   min(c1 * 64, coded_w), min(r1 * 64, coded_h))

    # wavefront schedule over device SBs: k = 2*r + c (left/above/
    # above-right/below-left deps all in earlier k; see module docstring)
    steps_map: dict = {}
    for r in range(sb_rows):
        for c_ in range(sb_cols):
            if dev[r, c_]:
                steps_map.setdefault(2 * r + c_, []).append((r, c_))
    ks = sorted(steps_map)
    K = len(ks)
    B = max(len(v) for v in steps_map.values())
    sbr = np.full((K, B), sb_rows, np.int32)  # invalid -> past the grid
    sbc = np.full((K, B), sb_cols, np.int32)
    valid = np.zeros((K, B), bool)
    allow = np.ones((K, B), bool)
    avail = np.zeros((K, B, 4, 5, 4), np.int32)
    avail8 = np.zeros((K, B, 4, 4, 4, 4), np.int32)
    sb_step = np.full((sb_rows, sb_cols), -1, np.int32)
    sb_lane = np.full((sb_rows, sb_cols), -1, np.int32)

    # decoder blockDecoded simulation in true decode order (tile raster,
    # SB raster, quadrant z, 16-leaf z).  mi granularity, SB-padded.
    pr, pc = h // 4, w // 4
    mi_coded = np.zeros((pr, pc), np.uint8)
    av_by_sb: dict = {}

    def edge_avail(px, py, tw, th, ty0, tx0, ty1, tx1):
        ha = 1 if py > ty0 else 0
        hl = 1 if px > tx0 else 0
        n_tr = 0
        n_bl = 0
        if py > ty0 and px + tw < tx1 and mi_coded[(py - 1) // 4, (px + tw) // 4]:
            n_tr = th
        if px > tx0 and py + th < ty1 and mi_coded[(py + th) // 4, (px - 1) // 4]:
            n_bl = tw
        return (ha, hl, n_tr, n_bl)

    for (c0, r0, c1, r1) in tiles:
        tx0, ty0 = c0 * 64, r0 * 64
        tx1 = min(c1 * 64, coded_w)
        ty1 = min(r1 * 64, coded_h)
        # per-tile context reset (mirrors _reset_tile_contexts)
        mi_coded[ty0 // 4 : (r1 * 64) // 4, tx0 // 4 : (c1 * 64) // 4] = 0
        for r in range(r0, r1):
            for c_ in range(c0, c1):
                sy, sx = r * 64, c_ * 64
                if not dev[r, c_]:
                    # host-path SB: its leaves all decode now; mark the mi
                    # region (clamped at the grid) atomically
                    mi_coded[sy // 4 : min((sy + 64) // 4, mi_rows),
                             sx // 4 : min((sx + 64) // 4, mi_cols)] = 1
                    continue
                slots = np.zeros((4, 5, 4), np.int32)
                slots8 = np.zeros((4, 4, 4, 4), np.int32)
                for q in range(4):
                    qy, qx = sy + _QOFF[q][0], sx + _QOFF[q][1]
                    slots[q, 0] = edge_avail(qx, qy, 32, 32, ty0, tx0, ty1, tx1)
                    for s in range(4):
                        yy, xx = qy + _SOFF[s][0], qx + _SOFF[s][1]
                        slots[q, 1 + s] = edge_avail(xx, yy, 16, 16,
                                                     ty0, tx0, ty1, tx1)
                        # 8x8 sub-leaves in z-order: availability is a pure
                        # function of decode position (spec 7.11.2), so it
                        # can be simulated here regardless of whether the
                        # split is chosen (marking mi per-8 reproduces the
                        # per-16 marking when all four are done)
                        for e in range(4):
                            ey, ex = yy + _SOFF8[e][0], xx + _SOFF8[e][1]
                            slots8[q, s, e] = edge_avail(ex, ey, 8, 8,
                                                         ty0, tx0, ty1, tx1)
                            mi_coded[ey // 4 : (ey + 8) // 4,
                                     ex // 4 : (ex + 8) // 4] = 1
                av_by_sb[(r, c_)] = (slots, slots8)

    for ki, k in enumerate(ks):
        for li, (r, c_) in enumerate(steps_map[k]):
            sbr[ki, li] = r
            sbc[ki, li] = c_
            valid[ki, li] = True
            avail[ki, li], avail8[ki, li] = av_by_sb[(r, c_)]
            sb_step[r, c_] = ki
            sb_lane[r, c_] = li
            if partial_col and dev[r].any() and c_ == np.nonzero(dev[r])[0][-1]:
                allow[ki, li] = False

    geom = WavefrontGeometry(h=h, w=w, mi_cols=mi_cols, mi_rows=mi_rows,
                             steps=K, width=B, sbr=sbr, sbc=sbc, valid=valid,
                             avail=avail, avail8=avail8, allow_z1=allow,
                             device_sb=dev, sb_step=sb_step, sb_lane=sb_lane)
    _GEOM_CACHE[key] = geom
    return geom


# ---------------------------------------------------------------------------
# device pass
# ---------------------------------------------------------------------------


_PASS_CACHE: dict = {}

# directional mode ids (intra_np order)
_DIR_MODES = np.array([ij.V, ij.H, ij.D45, ij.D135, ij.D113, ij.D157,
                       ij.D203, ij.D67])
_IS_DIR = np.zeros(13, bool)
_IS_DIR[_DIR_MODES] = True
# luma tx-type RD candidates: (set-2 symbol, tx type, matrix key) — the full
# DTT4_IDTX set the reduced_tx_set=1 stream can signal
LUMA_TT = ((1, tn.DCT_DCT, 0), (2, tn.ADST_ADST, 1), (3, tn.ADST_DCT, 2),
           (4, tn.DCT_ADST, 3), (0, tn.IDTX, 4))
# chroma uv-mode RD candidates: (uv mode id, derived tx type — spec
# Mode_To_Txfm_Type — and its matrix key), in intra_pred NONDIR order
UV_CANDS = ((0, tn.DCT_DCT, 0), (1, tn.ADST_DCT, 2), (2, tn.DCT_ADST, 3),
            (9, tn.ADST_ADST, 1), (10, tn.ADST_DCT, 2),
            (11, tn.DCT_ADST, 3), (12, tn.ADST_ADST, 1))
_MAT_TYPES = (tn.DCT_DCT, tn.ADST_ADST, tn.ADST_DCT, tn.DCT_ADST, tn.IDTX)
FIELDS = ("mode", "delta", "tt", "skip", "au", "av", "uv")
# the inter pass's records add the MVs as (high, low) 6-bit nibble pairs
MV_FIELDS = ("mvrh", "mvrl", "mvch", "mvcl")

# inter pass constants: candidate counts per level, the mv-coding bit
# overhead added to every inter candidate on top of its per-candidate
# bias (is_inter + ref + mode symbols), and the rate in bits a lone +-1
# AC level is taken to cost (the host encoder's _thin_rate_bits)
NCAND32 = 8
NCAND64 = 8
INTER_MODE_BITS = 5.0
THIN_RATE = 4.0


def build_pass(Hp: int, Wp: int, K: int, B: int, bd: int, cfl_on: bool,
               tx_search: bool, fine_dir: bool, mode_mask: tuple,
               mi_cols: int, mi_rows: int, allow_split: bool,
               allow_split8: bool = False, uv_search: bool = False,
               allow_n64: bool = False, inter_on: bool = False,
               device="cuda"):
    """Build (cached) the wavefront pass for one geometry/config."""
    key = (Hp, Wp, K, B, bd, cfl_on, tx_search, fine_dir, mode_mask,
           mi_cols, mi_rows, allow_split, allow_split8, uv_search,
           allow_n64, inter_on, str(device))
    fn = _PASS_CACHE.get(key)
    if fn is None:
        fn = WavefrontPass(*key[:-1], device=device)
        _PASS_CACHE[key] = fn
    return fn


def rec_width(inter_on: bool) -> int:
    """Per-(step, quad, lane) packed record width in int16 words: metadata
    (split flag + per-block fields + split16 flags) then the merged Y/U/V
    level buffers."""
    nf = 11 if inter_on else 7  # fields per block record
    return 1 + 4 + nf * (1 + 4 + 16) + 1536


class WavefrontPass(torch.nn.Module):
    """The wavefront pass (counterpart of wavefront.py _make_pass): a loop
    over SB anti-diagonals, each step encoding a batch of lanes (one SB
    each) through the 64x64 root trial, the 32x32 quadrants, their 16x16
    leaves and, with allow_split8, the 8x8 leaves of each 16x16, with the
    recon carried in SB tiles.  With inter_on,
    phase A (_inter_phase) first decides every block's inter candidate at
    each level, and every leaf races its intra result against it.

    Its math runs in the kernels: intra_pred (K1) for every prediction,
    fwd_txq (K2) for every forward transform with its quantiser and RD
    sums, inv_txfm (K3) for every reconstruction, and in phase A
    me_fullpel (K10) and mc_pred (K9); the glue here is small gathers,
    selects and sums.  The constant matrices are the module's buffers."""

    def __init__(self, Hp, Wp, K, B, bd, cfl_on, tx_search, fine_dir,
                 mode_mask, mi_cols, mi_rows, allow_split, allow_split8,
                 uv_search, allow_n64, inter_on, device="cuda"):
        super().__init__()
        self.Hp, self.Wp, self.K, self.B, self.bd = Hp, Wp, K, B, bd
        self.R, self.C = Hp // 64, Wp // 64
        self.tx_search, self.fine_dir = tx_search, fine_dir
        self.cfl_on = cfl_on
        self.allow_split, self.uv_search = allow_split, uv_search
        self.allow_split8 = allow_split8
        self.allow_n64 = allow_n64
        self.inter_on = inter_on
        self.fields = FIELDS + (MV_FIELDS if inter_on else ())
        self.maxval = (1 << bd) - 1
        self.base = 1 << (bd - 1)
        self.device = torch.device(device)
        dev = self.device

        def stack(n, keys, rows=None):
            ms = [tt.fwd_mats(_MAT_TYPES[k], n, n) for k in keys]
            Fv = np.stack([m[0] for m in ms])
            FhT = np.stack([m[1] for m in ms])
            if rows is not None:
                Fv, FhT = Fv[:, :rows, :], FhT[:, :, :rows]
            return (torch.as_tensor(np.ascontiguousarray(Fv), device=dev),
                    torch.as_tensor(np.ascontiguousarray(FhT), device=dev))

        # (T, m, n) matrix stacks indexed by the keys of LUMA_TT/UV_CANDS
        # (n = 4: the chroma of an 8x8 leaf)
        self.mats = {n: stack(n, (0,)) for n in (4, 8, 16, 32)}
        self.mats5 = {n: stack(n, range(5)) for n in (4, 8, 16)}
        # TX_64X64 keeps only the top-left 32x32 coefficients (spec 7.13.3
        # zero rule); for the orthogonal DCT basis, truncating the forward
        # matrices to those rows/cols IS the least-squares fit
        self.mats[64] = stack(64, (0,), rows=32)
        allow = np.asarray(mode_mask, bool)
        z1 = (np.arange(13) == ij.D45) | (np.arange(13) == ij.D67)
        self.register_buffer("base_mask", torch.as_tensor(allow, device=dev))
        self.register_buffer("not_z1", torch.as_tensor(~z1, device=dev))
        self.register_buffer("is_dir", torch.as_tensor(_IS_DIR, device=dev))
        i32 = dict(dtype=torch.int32, device=dev)
        self.tt_sym = torch.as_tensor([s for s, _, _ in LUMA_TT], **i32)
        self.tt_types = torch.as_tensor([t for _, t, _ in LUMA_TT], **i32)
        self.uv_ids = torch.as_tensor([c[0] for c in UV_CANDS], **i32)
        self.uv_types = torch.as_tensor([c[1] for c in UV_CANDS], **i32)
        self.uv_keys = torch.as_tensor([c[2] for c in UV_CANDS], **i32)
        self.mode64 = torch.as_tensor([0, 1, 2, 9, 10, 11, 12], **i32)
        if inter_on:
            # tx_alpha of each inter level's luma transform (64: the coded
            # 32x32 corner) for the thinning threshold
            self.tx_alpha = {n: tn.tx_alpha(min(n, 32), min(n, 32), bd)
                             for n in (64, 32, 16)}

    # -- building blocks ----------------------------------------------------

    def edges_local(self, ctx, ly, lx, w, h, ha, hl, ntr, nbl):
        """Spec 7.11.2 edge build from a context tile.  ctx: (B, Hc, Wc)
        with the block's top-left recon sample at ctx[1+ly, 1+lx]; row 0 /
        col 0 are the halo.  ly/lx are python ints (same for all lanes)."""
        n = w + h
        i = torch.arange(n, device=ctx.device)[None, :]
        row = ctx[:, ly, :]
        colv = ctx[:, :, lx]
        avail_a = w + torch.clamp(ntr, max=h).long()
        idx_a = (1 + lx + torch.minimum(i, avail_a[:, None] - 1)).clamp(
            max=row.shape[1] - 1)
        above_px = torch.gather(row, 1, idx_a)
        avail_l = h + torch.clamp(nbl, max=w).long()
        idx_l = (1 + ly + torch.minimum(i, avail_l[:, None] - 1)).clamp(
            max=colv.shape[1] - 1)
        left_px = torch.gather(colv, 1, idx_l)
        lt = colv[:, 1 + ly]
        tr = row[:, 1 + lx]
        corner = row[:, lx]
        b = self.base
        above_v = torch.where(ha[:, None], above_px,
                              torch.where(hl[:, None], lt[:, None],
                                          torch.full_like(lt, b - 1)[:, None]))
        left_v = torch.where(hl[:, None], left_px,
                             torch.where(ha[:, None], tr[:, None],
                                         torch.full_like(tr, b + 1)[:, None]))
        tl = torch.where(ha & hl, corner,
                         torch.where(ha, tr, torch.where(hl, lt,
                                                         torch.full_like(lt, b))))
        return (torch.cat([tl[:, None], above_v], 1),
                torch.cat([tl[:, None], left_v], 1))

    @staticmethod
    def _pick(x, idx):
        """x[b, idx[b]] for x (B, M, ...) and idx (B,)."""
        return x[torch.arange(x.shape[0], device=x.device), idx]

    @staticmethod
    def _sse(a, b):
        return ((a - b).to(torch.float32) ** 2).sum((-1, -2))

    def chroma(self, ctxU, ctxV, src_u, src_v, ly2, lx2, n2, ha, hl, lam,
               qdc, qac, mode, tabs, recon_y):
        """The chroma of a leaf (wavefront.py:700-830): DC for both planes,
        with cfl_on CFL against DC (the CFL arm), then with uv_search the
        uv-mode race, whose non-DC winner overrides.  Returns per plane
        (pred, levels, inverse) of the outcome (B, 2, ...), the uv mode
        id, the per-plane coefficient rates and the CFL alphas (B, 2)."""
        bd = self.bd
        Bn = ha.shape[0]
        dev = ha.device
        zero = torch.zeros((Bn,), dtype=torch.int32, device=dev)
        ncand = 7 if self.uv_search else 1
        abU, lfU = self.edges_local(ctxU, ly2, lx2, n2, n2, ha, hl, zero, zero)
        abV, lfV = self.edges_local(ctxV, ly2, lx2, n2, n2, ha, hl, zero, zero)
        # both planes' candidates (NONDIR's first ncand) in one K1
        # launch: (B, 2, C, n2, n2)
        pred = ij.intra_pred((abU, abV), (lfU, lfV), ha, hl, n2, False, bd,
                             channels=ij.NONDIR_CHANNELS[:ncand])
        src = torch.stack([src_u, src_v], 1)
        resid = src[:, :, None] - pred
        q = lambda v: v[:, None, None].expand(Bn, 2, ncand)
        keys = self.uv_keys[:ncand].expand(Bn, 2, ncand)
        if self.uv_search:
            Fv, FhT = self.mats5[n2]
        else:
            Fv, FhT = self.mats[n2]
            keys = None
        lv, dq, _txd, rate = tt.fwd_txq(resid, Fv, FhT, q(qdc), q(qac), 0,
                                        tidx=keys, bit_depth=bd)
        inv = tt.inv_txfm(dq, self.uv_types[:ncand].expand(Bn, 2, ncand)
                          if self.uv_search else tn.DCT_DCT, bd)
        dd = self._sse(resid, inv)  # (B, 2, C)
        # the DC outcome (chroma_dc), which CFL may replace plane by plane
        out_p, out_l, out_i, out_r = (pred[:, :, 0], lv[:, :, 0],
                                      inv[:, :, 0], rate[:, :, 0])
        alpha = torch.zeros((Bn, 2), dtype=torch.int32, device=dev)
        uv_mode = torch.zeros_like(mode)
        if self.cfl_on:
            out_p, out_l, out_i, out_r, alpha, uv_mode = self._cfl(
                recon_y, out_p, src, out_l, out_i, out_r, dd[:, :, 0], lam,
                qdc, qac, mode, tabs)
        if self.uv_search:
            bits_uv14, _bs, _ba, bits_angle = tabs
            costs = []
            for ci, (uvid, _t, _k) in enumerate(UV_CANDS):
                tot = bits_uv14[mode, uvid] * lam
                if uvid in (1, 2):  # V/H pay the (always-0) angle delta
                    tot = tot + lam * bits_angle[uvid - 1]
                for p in (0, 1):
                    tot = tot + dd[:, p, ci] + lam * rate[:, p, ci]
                costs.append(tot)
            uvi = torch.argmin(torch.stack(costs, 1), dim=1)
            # a non-DC winner overrides the DC/CFL outcome (CFL competes
            # against DC only, the host _decide_chroma semantics)
            non_dc = uvi > 0
            ar = torch.arange(Bn, device=dev)
            sel = lambda x, o: torch.where(
                non_dc.reshape((Bn,) + (1,) * (o.dim() - 1)), x[ar, :, uvi],
                o)
            out_p, out_l, out_i, out_r = (sel(pred, out_p), sel(lv, out_l),
                                          sel(inv, out_i), sel(rate, out_r))
            uv_mode = torch.where(non_dc, self.uv_ids[uvi], uv_mode)
            alpha = torch.where(non_dc[:, None], 0, alpha)
        return out_p, out_l, out_i, uv_mode, out_r, alpha

    def _cfl(self, recon_y, pred_dc, src, lv_dc, inv_dc, rate_dc, dd_dc,
             lam, qdc, qac, mode, tabs):
        """CFL against DC for both planes (wavefront.py:709-762): the AC
        values, the alpha fit, the prediction and residual (K11's fit),
        each plane's transform (K2, K3), then K11's decision: the RD costs
        (dd_dc, rate_dc: the DC outcome's pixel SSE and coefficient rates)
        and the CFL-vs-DC choice with the uv-mode, sign and alpha symbol
        rates.  A plane whose alpha is 0 keeps DC.  Returns the chosen
        (pred, levels, inverse, rates) per plane, the alphas and the uv
        mode id (13 where CFL won)."""
        bd = self.bd
        Bn = recon_y.shape[0]
        n2 = pred_dc.shape[-1]
        alpha, pc, rc = ij.cfl(recon_y, pred_dc, src, bd)
        Fv, FhT = self.mats[n2]
        q2 = lambda v: v[:, None].expand(Bn, 2)
        lc, dqc, _t, ratec = tt.fwd_txq(rc, Fv, FhT, q2(qdc), q2(qac), 0,
                                        bit_depth=bd)
        ic = tt.inv_txfm(dqc, tn.DCT_DCT, bd)
        return ij.cfl_decide(rc, ic, lc, ratec, alpha, pc, pred_dc, lv_dc,
                             inv_dc, dd_dc, rate_dc, lam, mode, tabs)

    def encode_leaf(self, ctxY, ctxU, ctxV, sYt, sUt, sVt, ly, lx, n, av4,
                    lam, qdc, qac, allow_z1, tabs, inter=None):
        """One batch of n x n intra leaves at local offset (ly, lx) inside
        the SB, raced against the lanes' inter winners (inter: per-lane
        _inter_level outputs) in the inter pass.  Returns the recon blocks
        (Y, U, V), the block fields, the levels and the RD cost; the caller
        writes the recon into the context."""
        bd = self.bd
        shift = 1 if n == 32 else 0
        ha = av4[:, 0] > 0
        hl = av4[:, 1] > 0
        above, left = self.edges_local(ctxY, ly, lx, n, n, ha, hl,
                                       av4[:, 2], av4[:, 3])
        src = sYt[:, ly : ly + n, lx : lx + n]
        Bn = src.shape[0]
        if self.fine_dir:
            # K1's race: each base direction's best angle delta by SAD
            # (zone-1 deltas masked) before the RD race, and the 13 modes
            stack, di8 = ij.intra_pred(above, left, ha, hl, n, True, bd,
                                       src=src, allow_z1=allow_z1)
        else:  # the 13 modes at angle delta 0
            stack = ij.intra_pred(above, left, ha, hl, n, True, bd,
                                  channels=ij.STACK13_CHANNELS)
            di8 = None
        # mode selection by tx-domain RD over all 13 candidates
        Fv, FhT = self.mats[n]
        resid_all = src[:, None] - stack
        q13 = lambda v: v[:, None].expand(Bn, 13)
        _lv, _dq, txd, rate13 = tt.fwd_txq(resid_all, Fv, FhT, q13(qdc),
                                           q13(qac), shift, bit_depth=bd,
                                           levels=False)
        cost_all = txd * DIST_SCALE + lam[:, None] * rate13
        mask = self.base_mask[None, :] & (allow_z1[:, None] | self.not_z1[None, :])
        cost_all = torch.where(mask, cost_all, float(1 << 30))
        mode = torch.argmin(cost_all, dim=1)
        pred = self._pick(stack, mode)
        if di8 is None:
            delta = torch.zeros_like(mode)
        else:
            delta = self._pick(di8, torch.clamp(mode - 1, 0, 7)) - 3
            delta = torch.where(self.is_dir[mode], delta,
                                torch.zeros_like(delta))

        resid = src - pred
        if self.tx_search and n <= 16:
            # full DTT4_IDTX race on the winner residual
            Fv5, FhT5 = self.mats5[n]
            r5 = resid[:, None].expand(Bn, 5, n, n)
            q5 = lambda v: v[:, None].expand(Bn, 5)
            keys = torch.arange(5, dtype=torch.int32,
                                device=src.device).expand(Bn, 5)
            lv5, dq5, _t, rate5 = tt.fwd_txq(r5, Fv5, FhT5, q5(qdc), q5(qac),
                                             shift, tidx=keys, bit_depth=bd)
            inv5 = tt.inv_txfm(dq5, self.tt_types.expand(Bn, 5), bd)
            costs = self._sse(r5, inv5) + lam[:, None] * rate5
            sel = torch.argmin(costs, dim=1)
            tt_sym = self.tt_sym[sel]
            lv, rate_y = self._pick(lv5, sel), self._pick(rate5, sel)
            recon_y = torch.clamp(pred + self._pick(inv5, sel), 0,
                                  self.maxval)
        else:
            lv, dq, _t, rate_y = tt.fwd_txq(resid, Fv, FhT, qdc, qac, shift,
                                            bit_depth=bd)
            recon_y = tt.inv_txfm(dq, tn.DCT_DCT, bd, pred=pred)
            tt_sym = torch.ones_like(mode)

        n2 = n >> 1
        ly2, lx2 = ly >> 1, lx >> 1
        src_u = sUt[:, ly2 : ly2 + n2, lx2 : lx2 + n2]
        src_v = sVt[:, ly2 : ly2 + n2, lx2 : lx2 + n2]
        pc, lc, ic, uv_mode, rate_c, alpha = self.chroma(
            ctxU, ctxV, src_u, src_v, ly2, lx2, n2, ha, hl, lam, qdc, qac,
            mode, tabs, recon_y)
        recon_c = torch.clamp(pc + ic, 0, self.maxval)

        skip = (lv.abs().sum((-1, -2)) + lc[:, 0].abs().sum((-1, -2))
                + lc[:, 1].abs().sum((-1, -2))) == 0
        dist = self._sse(recon_y, src)
        dist = dist + self._sse(recon_c[:, 0], src_u)
        dist = dist + self._sse(recon_c[:, 1], src_v)
        rate = rate_y + rate_c[:, 0] + rate_c[:, 1] + 7.0
        cost = dist + lam * rate
        out = dict(mode=mode, delta=delta, tt=tt_sym, skip=skip,
                   au=alpha[:, 0], av=alpha[:, 1], uv=uv_mode)
        levels = (lv.to(torch.int16), lc[:, 0].to(torch.int16),
                  lc[:, 1].to(torch.int16))
        return self._race_inter((recon_y, recon_c[:, 0], recon_c[:, 1]), out,
                                levels, cost, inter)

    def _race_inter(self, recon, out, levels, cost, inter):
        """The intra-vs-inter race of a leaf (wavefront.py:849-886): where
        the lane's inter winner costs less, its recon, levels and fields
        (mode 13, delta 0, DCT_DCT, no CFL, DC chroma, its skip and MV)
        replace the intra ones.  Adds the MV nibble fields in the inter
        pass; a keyframe pass (inter None) returns its inputs."""
        if not self.inter_on:
            return recon, out, levels, cost
        isel = inter["cost"] < cost
        s3 = isel[:, None, None]
        recon = tuple(torch.where(s3, inter[k], r)
                      for k, r in zip(("recY", "recU", "recV"), recon))
        levels = tuple(torch.where(s3, inter[k], v)
                       for k, v in zip(("lvY", "lvU", "lvV"), levels))
        z = torch.zeros_like(out["mode"])
        out = dict(mode=torch.where(isel, 13, out["mode"]),
                   delta=torch.where(isel, z, out["delta"]),
                   tt=torch.where(isel, 1, out["tt"]),
                   skip=torch.where(isel, inter["skip"], out["skip"]),
                   au=torch.where(isel, z, out["au"]),
                   av=torch.where(isel, z, out["av"]),
                   uv=torch.where(isel, z, out["uv"]))
        for nm, k in (("mvr", "mvr"), ("mvc", "mvc")):
            mv = torch.where(isel, inter[k], 0)
            out[nm + "h"] = mv >> 6
            out[nm + "l"] = mv - ((mv >> 6) << 6)
        return recon, out, levels, torch.minimum(cost, inter["cost"])

    def encode_leaf64(self, ctxY, ctxU, ctxV, sYt, sUt, sVt, ha, hl, lam,
                      qdc, qac, inter=None):
        """Whole-SB 64x64 intra trial (PARTITION_NONE at the SB root).
        Candidates DC/V/H/SMOOTH*/PAETH (none reads past the plain
        above/left edges); luma TX_64X64 keeps the top-left 32x32
        coefficients; chroma is 32x32 DC with DCT."""
        bd = self.bd
        Bn = ha.shape[0]
        zero = torch.zeros((Bn,), dtype=torch.int32, device=ha.device)
        above, left = self.edges_local(ctxY, 0, 0, 64, 64, ha, hl, zero, zero)
        src = sYt
        stack = ij.intra_pred(above, left, ha, hl, 64, False, bd)
        Fv, FhT = self.mats[64]
        q7 = lambda v: v[:, None].expand(Bn, 7)
        lv_all, dq_all, txd, rate7 = tt.fwd_txq(src[:, None] - stack, Fv, FhT,
                                                q7(qdc), q7(qac), 2,
                                                bit_depth=bd)
        cost_all = txd * DIST_SCALE + lam[:, None] * rate7
        ci = torch.argmin(cost_all, dim=1)
        mode = self.mode64[ci]
        pred = self._pick(stack, ci)
        lv = self._pick(lv_all, ci)
        # TX_64X64 of the coded 32x32 corner, reconstructed in K3
        recon_y = tt.inv_txfm(self._pick(dq_all, ci), tn.DCT_DCT, bd,
                              pred=pred, tx64=True)
        Fvc, FhTc = self.mats[32]
        abU, lfU = self.edges_local(ctxU, 0, 0, 32, 32, ha, hl, zero, zero)
        abV, lfV = self.edges_local(ctxV, 0, 0, 32, 32, ha, hl, zero, zero)
        # both planes' DC in one K1 launch, then one K2 and one K3
        pc = ij.intra_pred((abU, abV), (lfU, lfV), ha, hl, 32, False, bd,
                           channels=(0,))[:, :, 0]  # (B, 2, 32, 32)
        q2 = lambda v: v[:, None].expand(Bn, 2)
        l_, d_, _t, r_ = tt.fwd_txq(torch.stack([sUt, sVt], 1) - pc, Fvc,
                                    FhTc, q2(qdc), q2(qac), 1,
                                    bit_depth=bd)  # TX_32X32 tx_scale
        rec_c = tt.inv_txfm(d_, tn.DCT_DCT, bd, pred=pc).unbind(1)
        lv_c, rate_c = l_.unbind(1), r_.unbind(1)
        skip = (lv.abs().sum((-1, -2)) + lv_c[0].abs().sum((-1, -2))
                + lv_c[1].abs().sum((-1, -2))) == 0
        dist = self._sse(recon_y, src)
        dist = dist + self._sse(rec_c[0], sUt)
        dist = dist + self._sse(rec_c[1], sVt)
        rate = self._pick(rate7, ci) + rate_c[0] + rate_c[1] + 7.0
        cost = dist + lam * rate
        zi = torch.zeros_like(mode)
        out = dict(mode=mode, delta=zi, tt=torch.ones_like(mode), skip=skip,
                   au=zi, av=zi, uv=zi)
        levels = (lv.to(torch.int16), lv_c[0].to(torch.int16),
                  lv_c[1].to(torch.int16))
        return self._race_inter((recon_y, rec_c[0], rec_c[1]), out, levels,
                                cost, inter)

    def compose_ctx(self, t, r, c, n, ext):
        """Context tile (B, n+1, n+ext+1) from the tiled plane t (R,C,n,n):
        own tile framed by the above row (with above-right extension),
        left column and corner from neighbour tiles."""
        R, C = self.R, self.C

        def g(rr, cc):
            return t[torch.clamp(rr, 0, R - 1), torch.clamp(cc, 0, C - 1)]

        own, ab, lf = g(r, c), g(r - 1, c), g(r, c - 1)
        al, ar = g(r - 1, c - 1), g(r - 1, c + 1)
        ctx = torch.zeros((own.shape[0], n + 1, n + ext + 1),
                          dtype=torch.int32, device=t.device)
        ctx[:, 0, 0] = al[:, -1, -1]
        ctx[:, 0, 1 : n + 1] = ab[:, -1, :]
        ctx[:, 0, n + 1 :] = ar[:, -1, :ext]
        ctx[:, 1:, 0] = lf[:, :, -1]
        ctx[:, 1:, 1:n + 1] = own
        return ctx

    # -- phase A of the inter pass ------------------------------------------

    def _inter_candidates(self, me8):
        """Per-block MV candidate sets and rate biases from the in-pass ME
        map (wavefront.py:339 _inter_candidates_dev).  me8: (R2, C2, 2)
        int32 full-pel MVs in 1/8-pel units.  Returns (c32 (R*C*4, 8, 2),
        b32 (R*C*4, 8), c64 (R*C, 8, 2), b64 (R*C, 8)) in _grid_blocks
        order; the MVs even (1/4-pel precision) and clipped to +-MV_LIMIT."""
        R, C = self.R, self.C
        lim = mc.MV_LIMIT
        left = torch.cat([me8[:, :1], me8[:, :-1]], 1)
        above = torch.cat([me8[:1], me8[:-1]], 0)
        d = lambda dy, dx: me8 + torch.as_tensor((dy, dx), dtype=torch.int32,
                                                 device=me8.device)
        c32 = torch.stack([torch.zeros_like(me8), me8, d(-2, 0), d(2, 0),
                           d(0, -2), d(0, 2), left, above], 2)
        c32 = torch.clamp(c32, -lim, lim)
        c32 = c32 + (c32 & 1)
        lg = lambda v: torch.log2(1.0 + torch.abs(v).to(torch.float32))
        b32 = (6.0 + lg(c32[..., 0] - left[..., None, 0])
               + lg(c32[..., 1] - left[..., None, 1]))
        b32[..., 0] = 2.0  # zero -> GLOBAL-ish
        b32[..., 6] = 4.0  # left -> NEAREST/NEAR-ish
        b32[..., 7] = 4.0  # above
        q4 = me8.reshape(R, 2, C, 2, 2).permute(0, 2, 1, 3, 4).reshape(
            R, C, 4, 2)
        # float mean truncated toward zero (jnp astype), then even
        mean = (q4.to(torch.float32).mean(2) / 2).to(torch.int32) * 2
        m = lambda dy, dx: mean + torch.as_tensor((dy, dx), dtype=torch.int32,
                                                  device=me8.device)
        c64 = torch.stack([torch.zeros_like(mean), q4[:, :, 0], q4[:, :, 1],
                           q4[:, :, 2], q4[:, :, 3], mean, m(0, 2), m(2, 0)],
                          2)
        c64 = torch.clamp(c64, -lim, lim)
        c64 = c64 + (c64 & 1)
        b64 = 6.0 + lg(c64[..., 0]) + lg(c64[..., 1])
        b64[..., 0] = 2.0
        c32q = c32.reshape(R, 2, C, 2, NCAND32, 2).permute(
            0, 2, 1, 3, 4, 5).reshape(R * C * 4, NCAND32, 2)
        b32q = b32.reshape(R, 2, C, 2, NCAND32).permute(
            0, 2, 1, 3, 4).reshape(R * C * 4, NCAND32)
        return (c32q.contiguous(), b32q.contiguous(),
                c64.reshape(R * C, NCAND64, 2), b64.reshape(R * C, NCAND64))

    def _grid_blocks(self, n, device):
        """(py, px) int32 plane coordinates of the n-blocks of every SB in
        (R, C, quad[, leaf]) order (the _QOFF/_SOFF z-order)."""
        R, C = self.R, self.C
        if n == 64:
            idx = np.arange(R * C)
            py, px = (idx // C) * 64, (idx % C) * 64
        elif n == 32:
            idx = np.arange(R * C * 4)
            q = idx % 4
            py = (idx // (C * 4)) * 64 + np.asarray(_QOFF)[q, 0]
            px = ((idx // 4) % C) * 64 + np.asarray(_QOFF)[q, 1]
        else:  # 16: (R, C, quad, leaf)
            idx = np.arange(R * C * 16)
            sl, q = idx % 4, (idx // 4) % 4
            py = (idx // (C * 16)) * 64 + np.asarray(_QOFF)[q, 0] \
                + np.asarray(_SOFF)[sl, 0]
            px = ((idx // 16) % C) * 64 + np.asarray(_QOFF)[q, 1] \
                + np.asarray(_SOFF)[sl, 1]
        i32 = dict(dtype=torch.int32, device=device)
        return torch.as_tensor(py, **i32), torch.as_tensor(px, **i32)

    def _src_blocks(self, plane, n, sub):
        """(N, n >> sub, n >> sub) source blocks in _grid_blocks order."""
        R, C = self.R, self.C
        n2 = n >> sub
        if n == 64:
            b = plane.reshape(R, n2, C, n2).permute(0, 2, 1, 3)
        elif n == 32:
            b = plane.reshape(R, 2, n2, C, 2, n2).permute(0, 3, 1, 4, 2, 5)
        else:
            b = plane.reshape(R, 2, 2, n2, C, 2, 2, n2).permute(
                0, 4, 1, 5, 2, 6, 3, 7)
        return b.reshape(-1, n2, n2)

    @staticmethod
    def _sse_exact(a, b):
        """Per-block sum of squared differences, summed exactly in int64
        and rounded to float32 once."""
        d = (a - b).to(torch.int64)
        return (d * d).sum((-1, -2)).to(torch.float32)

    def _inter_level(self, n, refs, srcs, srcs8, cands_mv, cands_bits, lam_f,
                     qdc, qac):
        """Candidate race + winner coding of every n-block of the frame
        (wavefront.py:416 _inter_level).  refs: padded Y, U, V planes;
        srcs: Y, U, V int32 source planes, srcs8 the same as uploaded
        (uint8); cands_mv (N, Cn, 2) luma 1/8-pel, cands_bits (N, Cn) rate
        biases, lam_f/qdc/qac (N,).  All candidates of the level race in
        one K9 launch, which writes their residuals (the prediction is
        src - residual), and one K2 launch (with level-1 thinning); the
        winner's luma comes from the race, its chroma from one K9 launch
        for both planes (prediction and residual), one K2 (thinned) and
        one K3 launch.  Returns a dict of per-block outputs in
        _grid_blocks order."""
        bd = self.bd
        dev = lam_f.device
        N, Cn = cands_mv.shape[:2]
        py, px = self._grid_blocks(n, dev)
        src_b = self._src_blocks(srcs[0], n, 0)
        n2 = n >> 1
        shift, shift_c = tx_scale(n, n), tx_scale(n2, n2)
        qacf = qac.to(torch.float32)
        thr1 = (lam_f * THIN_RATE / (self.tx_alpha[n] * qacf) + qac) / 2.0
        resid_all = mc.mc_block_batch(
            refs[0], mc.MC_MARGIN, px, py, cands_mv[..., 0].reshape(-1),
            cands_mv[..., 1].reshape(-1), n, n, 0, 0, bd, src=srcs8[0],
            cands=Cn).reshape(N, Cn, n, n)
        Fv, FhT = self.mats[n]
        ex = lambda v: v[:, None].expand(N, Cn)
        lv_all, dq_all, txd, rate_all = tt.fwd_txq(
            resid_all, Fv, FhT, ex(qdc), ex(qac), shift, bit_depth=bd,
            thr=ex(thr1))
        costs = txd * DIST_SCALE + lam_f[:, None] * (rate_all + cands_bits)
        ci = torch.argmin(costs, dim=1)
        mv = self._pick(cands_mv, ci)
        mv_bits = self._pick(cands_bits, ci)
        mvr, mvc = mv[:, 0].contiguous(), mv[:, 1].contiguous()
        # the winner's prediction, exactly: src - (src - pred)
        pred = src_b - self._pick(resid_all, ci)
        lv, dq, rate = (self._pick(lv_all, ci), self._pick(dq_all, ci),
                        self._pick(rate_all, ci))
        # at n = 64 the coded 32x32 corner of TX_64X64
        recon = tt.inv_txfm(dq, tn.DCT_DCT, bd, pred=pred, tx64=n == 64)
        pred_c, resid_c = mc.mc_block_batch(
            (refs[1], refs[2]), mc.MC_MARGIN, px >> 1, py >> 1, mvr, mvc, n2,
            n2, 1, 1, bd, src=(srcs8[1], srcs8[2]), both=True)
        src_c = torch.stack([self._src_blocks(srcs[p], n, 1) for p in (1, 2)],
                            1)
        FvC, FhTC = self.mats[n2]
        ex2 = lambda v: v[:, None].expand(N, 2)
        lv_c, dq_c, _t, rate_c = tt.fwd_txq(
            resid_c, FvC, FhTC, ex2(qdc), ex2(qac), shift_c, bit_depth=bd,
            thr=ex2(thr1))
        recon_c = tt.inv_txfm(dq_c, tn.DCT_DCT, bd, pred=pred_c)
        # skip-vs-code RD over all three planes (host _block analog)
        sse = self._sse_exact
        dist_code = (sse(recon, src_b) + sse(recon_c[:, 0], src_c[:, 0])
                     + sse(recon_c[:, 1], src_c[:, 1]))
        dist_skip = (sse(pred, src_b) + sse(pred_c[:, 0], src_c[:, 0])
                     + sse(pred_c[:, 1], src_c[:, 1]))
        rate = rate + rate_c[:, 0] + rate_c[:, 1]
        has = (lv != 0).any(-1).any(-1) | (lv_c != 0).flatten(1).any(1)
        skip = ~has | (dist_skip + lam_f * 2.0 < dist_code + lam_f * rate)
        s3 = skip[:, None, None]
        s4 = skip[:, None, None, None]
        over = mv_bits + INTER_MODE_BITS
        cost = torch.where(skip, dist_skip + lam_f * (2.0 + over),
                           dist_code + lam_f * (rate + over))
        lv_c = torch.where(s4, torch.zeros_like(lv_c), lv_c).to(torch.int16)
        recon_c = torch.where(s4, pred_c, recon_c)
        return dict(cost=cost, skip=skip, mvr=mvr, mvc=mvc,
                    recY=torch.where(s3, pred, recon),
                    recU=recon_c[:, 0], recV=recon_c[:, 1],
                    lvY=torch.where(s3, torch.zeros_like(lv), lv).to(
                        torch.int16),
                    lvU=lv_c[:, 0], lvV=lv_c[:, 1])

    def _inter_phase(self, upload, srcs, srcs8, params, o, ro):
        """Phase A of the inter pass (wavefront.py:1032-1096): the per-32
        lambda/quantiser grids from the parameter vector at offset o, the
        padded reference planes at byte ro of the upload, the in-pass ME
        (K10) on the uint8 luma of srcs8 (the uploaded Y, U, V), the
        candidates, and the three levels' races.  Returns (i64, i32, i16)
        dicts shaped (R, C[, 4[, 4]], ...) and the ME map in 1/8 pel."""
        R, C, Hp, Wp = self.R, self.C, self.Hp, self.Wp
        RC4 = R * C * 4
        lam32 = params[o : o + RC4]
        qdc32 = params[o + RC4 : o + 2 * RC4].to(torch.int32)
        qac32 = params[o + 2 * RC4 : o + 3 * RC4].to(torch.int32)
        M = mc.MC_MARGIN
        HpM, WpM = Hp + 2 * M, Wp + 2 * M
        HcM, WcM = (Hp >> 1) + 2 * M, (Wp >> 1) + 2 * M
        refYp = upload[ro : ro + HpM * WpM].reshape(HpM, WpM)
        ro += HpM * WpM
        refUp = upload[ro : ro + HcM * WcM].reshape(HcM, WcM)
        ro += HcM * WcM
        refVp = upload[ro : ro + HcM * WcM].reshape(HcM, WcM)
        refs = (refYp, refUp, refVp)
        core = refYp[M : M + Hp, M : M + Wp]
        me8 = dp.me_fullpel(srcs8[0], core, 32) * 8  # (R2, C2, 2)
        cand32, cbits32, cand64, cbits64 = self._inter_candidates(me8)
        lam64 = lam32.reshape(-1, 4).mean(1)
        qdc64 = qdc32.reshape(-1, 4)[:, 0]
        qac64 = qac32.reshape(-1, 4)[:, 0]
        i64 = self._inter_level(64, refs, srcs, srcs8, cand64, cbits64, lam64,
                                qdc64, qac64)
        i32 = self._inter_level(32, refs, srcs, srcs8, cand32, cbits32, lam32,
                                qdc32, qac32)
        # 16-level candidates from the 32 winner: winner, zero and the
        # quarter-pel nudges (6 instead of 12 races)
        w32 = torch.stack([i32["mvr"], i32["mvc"]], -1)[:, None, :]
        nudges = torch.as_tensor(((0, 0), (-2, 0), (2, 0), (0, -2), (0, 2)),
                                 dtype=torch.int32, device=w32.device)
        cand16 = torch.cat([torch.zeros_like(w32), w32 + nudges[None]], 1)
        cand16 = torch.clamp(cand16, -mc.MV_LIMIT, mc.MV_LIMIT)
        cand16 = cand16 + (cand16 & 1)
        cbits16 = torch.as_tensor([2.0, 4.0, 7.0, 7.0, 7.0, 7.0],
                                  device=w32.device).expand(cand16.shape[:2])
        rep4 = lambda a: a.repeat_interleave(4, 0)
        i16 = self._inter_level(16, refs, srcs, srcs8, rep4(cand16),
                                rep4(cbits16), rep4(lam32), rep4(qdc32),
                                rep4(qac32))
        shape = lambda d, lead: {k: v.reshape(lead + v.shape[1:])
                                 for k, v in d.items()}
        return (shape(i64, (R, C)), shape(i32, (R, C, 4)),
                shape(i16, (R, C, 4, 4)), me8)

    # -- the pass -----------------------------------------------------------

    def forward(self, upload, sbr, sbc, valid, avail, avail8, allow):
        """upload: the packed uint8 vector the JAX pass takes — src Y/U/V
        bytes, then the float32 parameter vector (lambda/quantiser grids +
        CDF-derived mode-bit tables).  Returns the int16 records
        (K, 4, B, rec_width) and the uint8 recon planes (Y, U, V); the
        inter pass adds the band tail (wavefront.py:1382-1395): the ME map
        (R2, C2, 2) in 1/8 pel, then per level 64/32/16 the inter winners'
        costs (R, C[, 4[, 4]]) float32 and MVs (..., 2), as int16 MVs.
        The geometry arrays are WavefrontGeometry's (avail8, the 8x8
        leaves' availability, is read with allow_split8).

        The inter pass's upload continues after the keyframe parameters
        with the per-32 lambda/dc_q/ac_q grids (R*C*4 each, quadrant
        order) and then the edge-padded reference Y, U, V bytes
        (_inter_upload)."""
        Hp, Wp, K, B, R, C = self.Hp, self.Wp, self.K, self.B, self.R, self.C
        nY = Hp * Wp
        nC = (Hp >> 1) * (Wp >> 1)
        srcY = upload[:nY].reshape(Hp, Wp).to(torch.int32)
        srcU = upload[nY : nY + nC].reshape(Hp >> 1, Wp >> 1).to(torch.int32)
        srcV = upload[nY + nC : nY + 2 * nC].reshape(Hp >> 1, Wp >> 1).to(
            torch.int32)
        KB4 = K * B * 4
        plen = 3 * KB4 + 300 + (3 * R * C * 4 if self.inter_on else 0)
        params = upload[nY + 2 * nC : nY + 2 * nC + 4 * plen].view(
            torch.float32)
        o = 0
        lam_q = params[o : o + KB4].reshape(K, B, 4)
        o += KB4
        qdc_q = params[o : o + KB4].reshape(K, B, 4).to(torch.int32)
        o += KB4
        qac_q = params[o : o + KB4].reshape(K, B, 4).to(torch.int32)
        o += KB4
        part_bits = params[o : o + 2]
        part_bits16 = params[o + 2 : o + 4]
        part_bits64 = params[o + 4 : o + 6]
        o += 6
        bits_uv14 = params[o : o + 182].reshape(13, 14)
        bits_sign = params[o + 182 : o + 190]
        bits_alpha = params[o + 190 : o + 286].reshape(6, 16)
        o += 182 + 8 + 96
        bits_angle = params[o : o + 8]
        tabs = (bits_uv14, bits_sign, bits_alpha, bits_angle)
        if self.inter_on:
            # phase A: every inter block of every level, fully batched (MC
            # reads the reference, never the recon carry)
            srcs8 = (upload[:nY].reshape(Hp, Wp),
                     upload[nY : nY + nC].reshape(Hp >> 1, Wp >> 1),
                     upload[nY + nC : nY + 2 * nC].reshape(Hp >> 1, Wp >> 1))
            i64, i32, i16, me8 = self._inter_phase(
                upload, (srcY, srcU, srcV), srcs8, params, o + 8,
                nY + 2 * nC + 4 * plen)

        dev = upload.device
        tY = torch.zeros((R, C, 64, 64), dtype=torch.int32, device=dev)
        tU = torch.zeros((R, C, 32, 32), dtype=torch.int32, device=dev)
        tV = torch.zeros((R, C, 32, 32), dtype=torch.int32, device=dev)
        srcYt = srcY.reshape(R, 64, C, 64).permute(0, 2, 1, 3)
        srcUt = srcU.reshape(R, 32, C, 32).permute(0, 2, 1, 3)
        srcVt = srcV.reshape(R, 32, C, 32).permute(0, 2, 1, 3)
        sbr = sbr.long()
        sbc = sbc.long()
        steps = []
        for k in range(K):
            sbr_k, sbc_k, val_k = sbr[k], sbc[k], valid[k]
            av_k, allow_k = avail[k], allow[k]
            lam_k, qdc_k, qac_k = lam_q[k], qdc_q[k], qac_q[k]
            ctxY = self.compose_ctx(tY, sbr_k, sbc_k, 64, 32)
            ctxU = self.compose_ctx(tU, sbr_k, sbc_k, 32, 16)
            ctxV = self.compose_ctx(tV, sbr_k, sbc_k, 32, 16)
            rcl = torch.clamp(sbr_k, 0, R - 1)
            ccl = torch.clamp(sbc_k, 0, C - 1)
            sYt, sUt, sVt = srcYt[rcl, ccl], srcUt[rcl, ccl], srcVt[rcl, ccl]
            lane = lambda d, *ix: {k: v[(rcl, ccl) + ix]
                                   for k, v in d.items()}
            if self.allow_n64:
                # whole-SB 64x64 trial from the same pre-quad context
                r64 = self.encode_leaf64(
                    ctxY, ctxU, ctxV, sYt, sUt, sVt, av_k[:, 0, 0, 0] > 0,
                    av_k[:, 0, 0, 1] > 0, lam_k[:, 0], qdc_k[:, 0],
                    qac_k[:, 0], inter=lane(i64) if self.inter_on else None)
            quads = [self._quad(qi, ctxY, ctxU, ctxV, sYt, sUt, sVt,
                                av_k[:, qi], avail8[k][:, qi], lam_k[:, qi],
                                qdc_k[:, qi], qac_k[:, qi], allow_k, tabs,
                                part_bits, part_bits16,
                                lane(i32, qi) if self.inter_on else None,
                                [lane(i16, qi, si) for si in range(4)]
                                if self.inter_on else None)
                     for qi in range(4)]
            selY = ctxY[:, 1:65, 1:65]
            selU = ctxU[:, 1:33, 1:33]
            selV = ctxV[:, 1:33, 1:33]
            pick64 = None
            if self.allow_n64:
                quadsum = torch.stack([qd["cost"] for qd in quads], 0).sum(0)
                pick64 = (r64[3] + lam_k[:, 0] * part_bits64[0]
                          < quadsum + lam_k[:, 0] * part_bits64[1])
                p3 = pick64[:, None, None]
                selY = torch.where(p3, r64[0][0], selY)
                selU = torch.where(p3, r64[0][1], selU)
                selV = torch.where(p3, r64[0][2], selV)
            # write the finished SB tiles back (invalid lanes dropped)
            vr, vc = sbr_k[val_k], sbc_k[val_k]
            tY[vr, vc] = selY[val_k]
            tU[vr, vc] = selU[val_k]
            tV[vr, vc] = selV[val_k]
            steps.append(self._pack_step(quads, pick64,
                                         r64 if self.allow_n64 else None))
        packed = torch.stack(steps, 0)
        recY = tY.permute(0, 2, 1, 3).reshape(Hp, Wp).to(torch.uint8)
        recU = tU.permute(0, 2, 1, 3).reshape(Hp >> 1, Wp >> 1).to(torch.uint8)
        recV = tV.permute(0, 2, 1, 3).reshape(Hp >> 1, Wp >> 1).to(torch.uint8)
        if not self.inter_on:
            return packed, recY, recU, recV
        mv = lambda d: torch.stack([d["mvr"], d["mvc"]], -1).to(torch.int16)
        tail = (me8.to(torch.int16), i64["cost"], mv(i64), i32["cost"],
                mv(i32), i16["cost"], mv(i16))
        return packed, recY, recU, recV, tail

    def _quad(self, qi, ctxY, ctxU, ctxV, sYt, sUt, sVt, av_q, av8_q, lam,
              qdc, qac, allow_k, tabs, part_bits, part_bits16, inter32=None,
              inter16=None):
        """One 32x32 quadrant: the 32 leaf, then the chain of four 16
        leaves from the same context (with allow_split8 each 16 leaf
        raced against its four 8x8 leaves, _sixteen), NONE vs SPLIT, and
        the winner's recon written into the contexts (in place).  av8_q:
        (B, 4, 4, 4) availability of the quadrant's 8x8 leaves.
        inter32 / inter16: the lanes' inter winners of the quadrant and
        of its four 16 blocks."""
        qy, qx = _QOFF[qi]
        r32, out32, lv32, cost32 = self.encode_leaf(
            ctxY, ctxU, ctxV, sYt, sUt, sVt, qy, qx, 32, av_q[:, 0], lam,
            qdc, qac, allow_k, tabs, inter32)
        split8s, outs16, outs8, lvs16 = [], [], [], []
        c16sum = torch.zeros_like(cost32)
        for si in range(4):
            ly, lx = qy + _SOFF[si][0], qx + _SOFF[si][1]
            s8, out16, o8, lv16, c16 = self._sixteen(
                ctxY, ctxU, ctxV, sYt, sUt, sVt, ly, lx, av_q[:, 1 + si],
                av8_q[:, si], lam, qdc, qac, allow_k, tabs, part_bits16,
                inter16[si] if inter16 is not None else None)
            split8s.append(s8)
            outs16.append(out16)
            outs8.append(o8)
            lvs16.append(lv16)
            c16sum = c16sum + c16
        cost_none = cost32 + lam * part_bits[0]
        # with the 8x8 level each 16 cost already carries its own
        # partition bits; else four NONE symbols at 2 bits each
        cost_split = c16sum + lam * (
            part_bits[1] + (0.0 if self.allow_split8 else 4 * 2.0))
        split = cost_split < cost_none
        if not self.allow_split:  # rdo_partition off
            split = torch.zeros_like(split)
        s3 = split[:, None, None]
        ys, xs = slice(1 + qy, 33 + qy), slice(1 + qx, 33 + qx)
        ys2, xs2 = slice(1 + (qy >> 1), 17 + (qy >> 1)), slice(1 + (qx >> 1), 17 + (qx >> 1))
        ctxY[:, ys, xs] = torch.where(s3, ctxY[:, ys, xs], r32[0])
        ctxU[:, ys2, xs2] = torch.where(s3, ctxU[:, ys2, xs2], r32[1])
        ctxV[:, ys2, xs2] = torch.where(s3, ctxV[:, ys2, xs2], r32[2])
        Bn = split.shape[0]
        s2 = split[:, None]
        lvm = [torch.where(s2, torch.stack([l[p] for l in lvs16], 1).reshape(Bn, -1),
                           lv32[p].reshape(Bn, -1)) for p in range(3)]
        return dict(split=split, out32=out32, outs16=outs16, split8=split8s,
                    outs8=outs8, lv=lvm,
                    cost=torch.minimum(cost_none, cost_split))

    def _sixteen(self, ctxY, ctxU, ctxV, sYt, sUt, sVt, ly, lx, av16, av8,
                 lam, qdc, qac, allow_k, tabs, part_bits16, inter16):
        """One 16x16 leaf at (ly, lx), and with allow_split8 its NONE vs
        SPLIT race against four 8x8 leaves (wavefront.py:1153-1228).  Both
        sides predict from the same pre-leaf context: the 16 leaf's recon
        is held back while the 8-chain writes its leaves into the contexts
        one by one (each reads the ones before it), then the 16x16 luma
        and 8x8 chroma region keeps the winner's.  Returns (split8 (B,),
        the 16 leaf's fields, the four 8x8 leaves' fields (both None
        without allow_split8: _pack_step writes zeros), the chosen levels
        (B, 256), (B, 64), (B, 64) in leaf z-order, the chosen cost)."""
        r16, out16, lv16, c16 = self.encode_leaf(
            ctxY, ctxU, ctxV, sYt, sUt, sVt, ly, lx, 16, av16, lam, qdc, qac,
            allow_k, tabs, inter16)
        Bn = c16.shape[0]
        ys, xs = slice(1 + ly, 17 + ly), slice(1 + lx, 17 + lx)
        ys2, xs2 = slice(1 + (ly >> 1), 9 + (ly >> 1)), slice(1 + (lx >> 1), 9 + (lx >> 1))
        if not self.allow_split8:
            ctxY[:, ys, xs] = r16[0]
            ctxU[:, ys2, xs2] = r16[1]
            ctxV[:, ys2, xs2] = r16[2]
            return (None, out16, None, tuple(v.reshape(Bn, -1) for v in lv16),
                    c16)
        outs8, lvs8 = [], []
        c8sum = torch.zeros_like(c16)
        for ei in range(4):
            ey, ex = ly + _SOFF8[ei][0], lx + _SOFF8[ei][1]
            r8, out8, lv8, c8 = self.encode_leaf(
                ctxY, ctxU, ctxV, sYt, sUt, sVt, ey, ex, 8, av8[:, ei], lam,
                qdc, qac, allow_k, tabs)
            ctxY[:, 1 + ey : 9 + ey, 1 + ex : 9 + ex] = r8[0]
            ctxU[:, 1 + (ey >> 1) : 5 + (ey >> 1), 1 + (ex >> 1) : 5 + (ex >> 1)] = r8[1]
            ctxV[:, 1 + (ey >> 1) : 5 + (ey >> 1), 1 + (ex >> 1) : 5 + (ex >> 1)] = r8[2]
            outs8.append(out8)
            lvs8.append(lv8)
            c8sum = c8sum + c8
        cost_n = c16 + lam * part_bits16[0]
        cost_s = c8sum + lam * part_bits16[1]
        split8 = cost_s < cost_n
        s3 = split8[:, None, None]
        ctxY[:, ys, xs] = torch.where(s3, ctxY[:, ys, xs], r16[0])
        ctxU[:, ys2, xs2] = torch.where(s3, ctxU[:, ys2, xs2], r16[1])
        ctxV[:, ys2, xs2] = torch.where(s3, ctxV[:, ys2, xs2], r16[2])
        s2 = split8[:, None]
        lvm = tuple(torch.where(s2, torch.stack([l[p] for l in lvs8],
                                                1).reshape(Bn, -1),
                                lv16[p].reshape(Bn, -1)) for p in range(3))
        return split8, out16, outs8, lvm, torch.minimum(cost_n, cost_s)

    def _pack_step(self, quads, pick64, r64):
        """One step's records: (4, B, rec_width(inter_on)) int16 (layout
        of wavefront.py:1338-1368, int16 transport)."""
        Bn = quads[0]["split"].shape[0]
        nf = len(self.fields)
        dev = quads[0]["split"].device
        fld = lambda o: torch.stack([o[f].to(torch.int32)
                                     for f in self.fields], -1)
        m32 = torch.stack([fld(qd["out32"]) for qd in quads], 0)  # (4, B, nf)
        m16 = torch.stack([torch.stack([fld(o) for o in qd["outs16"]], 1)
                           for qd in quads], 0).reshape(4, Bn, 4 * nf)
        if self.allow_split8:
            s16 = torch.stack([torch.stack(qd["split8"], 1) for qd in quads],
                              0).to(torch.int32)  # (4, B, 4)
            # (quad, B, 16-leaf, 8-leaf, field), as wavefront.py:1350-1351
            m8 = torch.stack([torch.stack([torch.stack([fld(o) for o in o8], 1)
                                           for o8 in qd["outs8"]], 1)
                              for qd in quads], 0).reshape(4, Bn, 16 * nf)
        else:
            s16 = torch.zeros((4, Bn, 4), dtype=torch.int32, device=dev)
            m8 = torch.zeros((4, Bn, 16 * nf), dtype=torch.int32, device=dev)
        split_f = torch.stack([qd["split"] for qd in quads], 0).to(torch.int32)
        lv = [torch.stack([qd["lv"][p] for qd in quads], 0) for p in range(3)]
        if pick64 is not None:
            # a chosen 64x64 root block: flag 2 in meta[0]; its header
            # fields ride quad 0's out32 slots, its TX_64X64 luma levels
            # (32x32 corner) quad 0's lv_y, and the 32x32 chroma levels
            # quads 1/2's lv_y slots (native wavefront_cache_push_run)
            split_f = torch.where(pick64[None], 2, split_f)
            m32[0] = torch.where(pick64[:, None], fld(r64[1]), m32[0])
            p2 = pick64[:, None]
            for qi in range(3):
                lv[0][qi] = torch.where(
                    p2, r64[2][qi].to(torch.int32).reshape(Bn, -1).to(lv[0].dtype),
                    lv[0][qi])
        meta = torch.cat([split_f[..., None], m32, s16, m16, m8], -1).to(
            torch.int16)
        return torch.cat([meta] + [x.to(torch.int16) for x in lv], -1)


# ---------------------------------------------------------------------------
# host side: launches and record unpacking
# ---------------------------------------------------------------------------


class WavefrontResult:
    """Numpy views over one device pass: recon planes, split map, and
    per-SB block records in decode order."""

    route = "single"  # the key frame's route (parallel/tiles.py: "tiles")

    def __init__(self, geom: WavefrontGeometry, rec, split, out32, out16,
                 levels, split16=None, out8=None, packed=None, none64=None,
                 has_mv=False):
        self.geom = geom
        self.has_mv = has_mv  # inter records (sb_records appends mvr, mvc)
        # raw (K, 4, B, 1688) int16 device output — the native cache-build
        # fast path walks it directly (ec/native_block.py
        # cache_push_wavefront)
        self.packed = packed
        self.none64 = none64  # (K, B) bool: SB coded as one 64x64 block
        self.rec = rec  # [Y, U, V] int32 numpy
        # stacked (K, 4, B[, ...]) / (K, 4, 4, B[, ...]) / (K, 4, 4, 4, B)
        self.split = split
        self.out32 = out32
        self.out16 = out16
        self.split16 = split16  # (K, 4, 4, B): per (quad, 16-leaf)
        self.out8 = out8
        # merged per-quadrant level buffers (K, 4, B, 1024|256): the
        # chosen side's coefficients (32x32 row-major, or 4x 16x16 /
        # 16x 8x8 in leaf z-order when split)
        self.lv_y, self.lv_u, self.lv_v = levels
        sbrows, sbcols = geom.device_sb.shape
        self.split_map = np.zeros((sbrows * 2, sbcols * 2), bool)
        self.split16_map = np.zeros((sbrows * 4, sbcols * 4), bool)
        for r in range(sbrows):
            for c_ in range(sbcols):
                if not geom.device_sb[r, c_]:
                    continue
                k, li = geom.sb_step[r, c_], geom.sb_lane[r, c_]
                if none64 is not None and none64[k, li]:
                    continue
                for q in range(4):
                    qsplit = bool(split[k, q, li])
                    self.split_map[2 * r + (_QOFF[q][0] // 32),
                                   2 * c_ + (_QOFF[q][1] // 32)] = qsplit
                    if not (qsplit and split16 is not None):
                        continue
                    for s in range(4):
                        y16 = 4 * r + (_QOFF[q][0] + _SOFF[s][0]) // 16
                        x16 = 4 * c_ + (_QOFF[q][1] + _SOFF[s][1]) // 16
                        self.split16_map[y16, x16] = bool(split16[k, q, s, li])

    def sb_records(self, r: int, c_: int):
        """Block records for one device SB in decode order: list of
        (x, y, bw, bh, mode, skip, tt, ha, hl, au, av, delta, uv, lv_y,
        lv_u, lv_v[, mvr, mvc]); tt is the DTT4_IDTX set symbol.  The mv
        tail is present when has_mv (inter wavefront; mode 13 = inter
        with that MV, LAST reference)."""
        g = self.geom
        k, li = g.sb_step[r, c_], g.sb_lane[r, c_]
        sy, sx = r * 64, c_ * 64

        def mvtail(o, idx):
            if not self.has_mv:
                return ()
            return (int(o["mvr"][idx]), int(o["mvc"][idx]))

        if self.none64 is not None and self.none64[k, li]:
            # one 64x64 root block: header in quad 0's out32 slots, luma
            # TX_64X64 levels (32x32 corner) in quad 0's lv_y, chroma in
            # quads 1/2's lv_y slots
            o = self.out32
            avq = g.avail[k, li, 0]
            return [(sx, sy, 64, 64, int(o["mode"][k, 0, li]),
                     bool(o["skip"][k, 0, li]), int(o["tt"][k, 0, li]),
                     int(avq[0, 0]), int(avq[0, 1]),
                     int(o["au"][k, 0, li]), int(o["av"][k, 0, li]),
                     int(o["delta"][k, 0, li]), int(o["uv"][k, 0, li]),
                     self.lv_y[k, 0, li].reshape(32, 32),
                     self.lv_y[k, 1, li].reshape(32, 32),
                     self.lv_y[k, 2, li].reshape(32, 32))
                    + mvtail(o, (k, 0, li))]
        recs = []
        for q in range(4):
            avq = g.avail[k, li, q]
            if not self.split[k, q, li]:
                o = self.out32
                recs.append((sx + _QOFF[q][1], sy + _QOFF[q][0], 32, 32,
                             int(o["mode"][k, q, li]),
                             bool(o["skip"][k, q, li]),
                             int(o["tt"][k, q, li]),
                             int(avq[0, 0]), int(avq[0, 1]),
                             int(o["au"][k, q, li]), int(o["av"][k, q, li]),
                             int(o["delta"][k, q, li]),
                             int(o["uv"][k, q, li]),
                             self.lv_y[k, q, li].reshape(32, 32),
                             self.lv_u[k, q, li].reshape(16, 16),
                             self.lv_v[k, q, li].reshape(16, 16))
                            + mvtail(o, (k, q, li)))
            else:
                o = self.out16
                ly4 = self.lv_y[k, q, li].reshape(4, 256)
                lu4 = self.lv_u[k, q, li].reshape(4, 64)
                lv4 = self.lv_v[k, q, li].reshape(4, 64)
                for s in range(4):
                    x16 = sx + _QOFF[q][1] + _SOFF[s][1]
                    y16 = sy + _QOFF[q][0] + _SOFF[s][0]
                    if self.split16 is not None and self.split16[k, q, s, li]:
                        o8 = self.out8
                        av8 = g.avail8[k, li, q, s]
                        ly8 = ly4[s].reshape(4, 8, 8)
                        lu8 = lu4[s].reshape(4, 4, 4)
                        lv8 = lv4[s].reshape(4, 4, 4)
                        for e in range(4):
                            recs.append((x16 + _SOFF8[e][1],
                                         y16 + _SOFF8[e][0], 8, 8,
                                         int(o8["mode"][k, q, s, e, li]),
                                         bool(o8["skip"][k, q, s, e, li]),
                                         int(o8["tt"][k, q, s, e, li]),
                                         int(av8[e, 0]), int(av8[e, 1]),
                                         int(o8["au"][k, q, s, e, li]),
                                         int(o8["av"][k, q, s, e, li]),
                                         int(o8["delta"][k, q, s, e, li]),
                                         int(o8["uv"][k, q, s, e, li]),
                                         ly8[e], lu8[e], lv8[e])
                                        + mvtail(o8, (k, q, s, e, li)))
                        continue
                    recs.append((x16, y16, 16, 16,
                                 int(o["mode"][k, q, s, li]),
                                 bool(o["skip"][k, q, s, li]),
                                 int(o["tt"][k, q, s, li]),
                                 int(avq[1 + s, 0]), int(avq[1 + s, 1]),
                                 int(o["au"][k, q, s, li]),
                                 int(o["av"][k, q, s, li]),
                                 int(o["delta"][k, q, s, li]),
                                 int(o["uv"][k, q, s, li]),
                                 ly4[s].reshape(16, 16),
                                 lu4[s].reshape(8, 8),
                                 lv4[s].reshape(8, 8))
                                + mvtail(o, (k, q, s, li)))
        return recs


class LaunchedWavefront:
    """Handle to an enqueued device pass: its kernels are queued on the
    current stream; collect() copies the records and recon to the host
    (which waits for them)."""

    def __init__(self, geom, fe, out):
        self.geom = geom
        self.fe = fe
        # (records int16, recY, recU, recV[, band tail]) on the device
        self.out = out

    def collect(self) -> "WavefrontResult":
        r = unpack_wavefront(self.geom, self.out)
        r.dev_out = self.out[1:4]  # device-resident recon for the chain
        return r


def _mode_mask(fe) -> tuple:
    if fe.speed >= 9:
        return tuple(m in (0, 1, 2, 9, 12) for m in range(13))
    if fe.fine_dir:
        return tuple(True for _ in range(13))
    return tuple(m not in (ij.D45, ij.D67, ij.D203) for m in range(13))


def _pass_flags(fe) -> tuple:
    """The per-frame static config the pass is specialized on (everything
    in the build_pass key except geometry/shape)."""
    if getattr(fe, "wf_inter", False):
        # inter wavefront envelope: DC/V/H/SMOOTH/PAETH intra candidates,
        # no CFL/uv-race/angle-deltas/tx-search (the host symbol pass for
        # device blocks codes delta 0 + DC chroma), 64-root trial on
        return (fe.bd, False, False, False,
                tuple(m in (0, 1, 2, 9, 12) for m in range(13)),
                bool(fe.rdo_partition), False, False, True, True)
    return (fe.bd, bool(fe.cfl_search and fe.q > 0),
            bool(fe.tx_type_search and fe.q > 0), bool(fe.fine_dir),
            _mode_mask(fe), bool(fe.rdo_partition),
            bool(getattr(fe, "rdo_split8", False)),
            bool(getattr(fe, "uv_search", False) and fe.q > 0),
            bool(getattr(fe, "rdo_none64", False)), False)


def launch_wavefront(fe, tiles) -> LaunchedWavefront | None:
    """Enqueue the device pass for an IntraFrameEncoder-shaped host object.
    None when the frame has no full SB (pure host path)."""
    geom = geometry_for(fe.coded_w, fe.coded_h, fe.w, fe.h, fe.mi_cols,
                        fe.mi_rows, tuple(tiles))
    if geom is None:
        return None
    K, B = geom.steps, geom.width
    flags = _pass_flags(fe)
    fn = build_pass(fe.h, fe.w, K, B, flags[0], flags[1], flags[2], flags[3],
                    flags[4], fe.mi_cols, fe.mi_rows, flags[5], flags[6],
                    flags[7], flags[8], flags[9], device=fe.device)
    grids = _lane_grids(fe, geom)
    extra, ref_bytes = _inter_upload(fe) if flags[9] else ((), ())
    upload = pack_upload([fe.src], [grids], _mode_bit_params(fe), extra,
                         ref_bytes)
    up = torch.from_numpy(upload).to(fe.device)
    return LaunchedWavefront(geom, fe, fn(up, *_geom_dev(geom, fe.device)))


def _uniform_grids(fe, geom):
    """(lambda, dc_q, ac_q) float32 (K, B, 4) lane grids holding the
    frame's own values in every lane."""
    K, B = geom.steps, geom.width
    return tuple(np.full((K, B, 4), v, np.float32)
                 for v in (fe.lam, fe.dc_q, fe.ac_q))


def _lane_grids(fe, geom):
    """Per-quadrant (lambda, dc_q, ac_q) float32 (K, B, 4) lane grids."""
    grids = _uniform_grids(fe, geom)
    _fill_lane_params(fe, geom, *grids)
    return grids


def pack_upload(srcs, grids, bits, extra=(), ref_bytes=()) -> np.ndarray:
    """The pass's single uint8 input, laid out as the JAX pass reads it:
    every slot's Y, then every U, then every V (srcs: a [Y, U, V] list a
    slot, a frame or a tile column), then the float32 parameters (lane
    grids, slot f in lanes [f*B, (f+1)*B), then the shared mode-bit tail,
    then the inter pass's `extra` grids), then the inter pass's reference
    bytes."""
    cat = lambda i: np.concatenate([g[i] for g in grids], axis=1).ravel()
    params = np.concatenate([cat(0), cat(1), cat(2), bits, *extra]).astype(
        np.float32)
    return np.concatenate(
        [src[p].astype(np.uint8).ravel() for p in range(3) for src in srcs]
        + [params.view(np.uint8), *ref_bytes])


def _inter_upload(fe):
    """The inter pass's inputs beyond the keyframe ones (wavefront.py:1670
    _inter_upload): (params_extra, ref_byte_parts).  The ME and the
    candidates run on the device inside the pass; only the per-32
    lambda/quantiser grids (quadrant order) and the edge-padded reference
    planes ride the upload."""
    R, C = fe.h // 64, fe.w // 64
    r2, c2 = 2 * R, 2 * C
    lam32 = np.full((r2, c2), fe.lam, np.float32)
    lam_map = getattr(fe, "_lam_map", None)
    if lam_map is not None:
        yr = min(lam_map.shape[0], r2)
        xr = min(lam_map.shape[1], c2)
        lam32[:yr, :xr] = lam_map[:yr, :xr]
    lam32q = np.ascontiguousarray(
        lam32.reshape(R, 2, C, 2).transpose(0, 2, 1, 3))
    extra = (lam32q.ravel().astype(np.float32),
             np.full(R * C * 4, fe.dc_q, np.float32),
             np.full(R * C * 4, fe.ac_q, np.float32))
    refs = fe.refs[fe.ref_ids[0]]
    ref_bytes = [mc.pad_ref_plane(p, mc.MC_MARGIN, fe.h >> s, fe.w >> s)
                 .astype(np.uint8).ravel()
                 for p, s in zip(refs, (0, 1, 1))]
    return extra, ref_bytes


def _fill_lane_params(fe, geom, lam_q, qdc_q, qac_q) -> None:
    """Per-quadrant lambda / quantizers from the frame's activity-AQ and
    segmentation maps, into (K, B, 4) lane grids (vectorized over the
    K*B*4 lanes)."""
    lam_map = getattr(fe, "_lam_map", None)
    if lam_map is None and fe.seg_map is None:
        return
    qy = np.asarray([o[0] // 32 for o in _QOFF])[None, None, :]
    qx = np.asarray([o[1] // 32 for o in _QOFF])[None, None, :]
    y32 = geom.sbr[:, :, None] * 2 + qy  # (K, B, 4)
    x32 = geom.sbc[:, :, None] * 2 + qx
    valid = geom.valid[:, :, None]
    if lam_map is not None:
        yi = np.minimum(y32, lam_map.shape[0] - 1)
        xi = np.minimum(x32, lam_map.shape[1] - 1)
        lam_q[:] = np.where(valid, lam_map[yi, xi], lam_q)
    if fe.seg_map is not None:
        yi = np.minimum(y32 * 8, fe.seg_map.shape[0] - 1)
        xi = np.minimum(x32 * 8, fe.seg_map.shape[1] - 1)
        sid = fe.seg_map[yi, xi].astype(np.int64)
        seg_dc = np.asarray([d for (d, _a) in fe._seg_q], np.float32)
        seg_ac = np.asarray([a for (_d, a) in fe._seg_q], np.float32)
        seg_lam = np.asarray(fe._seg_lam, np.float32)
        qdc_q[:] = np.where(valid, seg_dc[sid], qdc_q)
        qac_q[:] = np.where(valid, seg_ac[sid], qac_q)
        lam_q[:] = np.where(valid, seg_lam[sid], lam_q)


def _geom_dev(geom, device, F: int = 1):
    """Geometry arrays on the device (constant per geometry, device and
    batch size F; frame f's lanes read SB rows offset by f*R)."""
    cache = geom.__dict__.setdefault("_tensors", {})
    key = (str(device), F)
    dev = cache.get(key)
    if dev is None:
        R = geom.h // 64
        tileF = lambda a: np.concatenate([a] * F, axis=1)
        sbr = np.concatenate([geom.sbr + f * R for f in range(F)], axis=1)
        dev = tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                    for a in (sbr, tileF(geom.sbc), tileF(geom.valid),
                              tileF(geom.avail), tileF(geom.avail8),
                              tileF(geom.allow_z1)))
        cache[key] = dev
    return dev


# ---------------------------------------------------------------------------
# multi-frame batched launch (consecutive key frames)
# ---------------------------------------------------------------------------
#
# The wavefront scan is latency-bound: each of its K steps runs ~B small
# per-lane block encodes.  Frames with no coding dependence on each other
# (consecutive KEY frames: each starts from default CDFs and references
# nothing) batch into ONE pass by stacking their planes vertically — same
# K steps, F*B lanes.


class _BatchSlot:
    """Per-frame handle into a batched launch (LaunchedWavefront API)."""

    def __init__(self, batch, f: int):
        self.batch = batch
        self.f = f
        self.geom = batch.geom

    def collect(self) -> "WavefrontResult":
        return self.batch.collect(self.f)


def split_batch(out, F: int, B: int, Hp: int) -> list:
    """Per-slot device views, in the single-frame layout, of a pass over F
    slots stacked along rows (B lanes and Hp rows a slot)."""
    rec, y, u, v = out
    return [(rec[:, :, f * B : (f + 1) * B],
             y[f * Hp : (f + 1) * Hp],
             u[f * (Hp >> 1) : (f + 1) * (Hp >> 1)],
             v[f * (Hp >> 1) : (f + 1) * (Hp >> 1)])
            for f in range(F)]


class LaunchedWavefrontBatch:
    def __init__(self, geom, fes, out):
        self.geom = geom
        self.fes = fes
        self.parts = split_batch(out, len(fes), geom.width, fes[0].h)

    def slot(self, f: int) -> _BatchSlot:
        return _BatchSlot(self, f)

    def collect(self, f: int) -> "WavefrontResult":
        r = unpack_wavefront(self.geom, self.parts[f])
        r.dev_out = self.parts[f][1:]  # device-resident recon for the chain
        return r


def launch_wavefront_batch(fes, tiles) -> LaunchedWavefrontBatch | None:
    """One device pass over F same-shape, same-config key frames (lanes =
    F*B, planes stacked along rows).  Returns None when ineligible; the
    caller then launches frame by frame."""
    if len(fes) < 2:
        return None
    fe0 = fes[0]
    geom = geometry_for(fe0.coded_w, fe0.coded_h, fe0.w, fe0.h, fe0.mi_cols,
                        fe0.mi_rows, tuple(tiles))
    if geom is None:
        return None
    flags0 = _pass_flags(fe0)
    bits0 = _mode_bit_params(fe0)
    for fe in fes[1:]:
        if (fe.w, fe.h, fe.coded_w, fe.coded_h) != (
                fe0.w, fe0.h, fe0.coded_w, fe0.coded_h):
            return None
        if _pass_flags(fe) != flags0 or fe.device != fe0.device:
            return None
        # mode-bit tables ride a single shared tail; all-key frames start
        # from the same initial CDFs so this matches in practice
        if not np.array_equal(_mode_bit_params(fe), bits0):
            return None
    F = len(fes)
    K, B = geom.steps, geom.width
    fn = build_pass(F * fe0.h, fe0.w, K, F * B, flags0[0], flags0[1],
                    flags0[2], flags0[3], flags0[4], fe0.mi_cols,
                    fe0.mi_rows, flags0[5], flags0[6], flags0[7], flags0[8],
                    device=fe0.device)
    upload = pack_upload([fe.src for fe in fes],
                         [_lane_grids(fe, geom) for fe in fes], bits0)
    up = torch.from_numpy(upload).to(fe0.device)
    out = fn(up, *_geom_dev(geom, fe0.device, F))
    return LaunchedWavefrontBatch(geom, list(fes), out)


def _sym_bits_row(row, n):
    out = np.empty(n, np.float32)
    for s in range(n):
        fl = 32768 if s == 0 else int(row[s - 1])
        p = max(fl - int(row[s]), 1) / 32768.0
        out[s] = -np.log2(p)
    return out


def _mode_bit_params(fe) -> np.ndarray:
    """Mode-symbol bit tables from the frame's initial CDFs, as the fixed
    float32 parameter tail the device pass unpacks: partition bits (2+2)
    + uv-mode bits (13x14) + CFL sign (8) + CFL alpha (6x16) + uv angle
    delta-0 bits per directional base (8)."""
    cdf = fe.cdf
    bits_uv14 = np.stack([_sym_bits_row(cdf.uv_mode[1][m], 14)
                          for m in range(13)])
    bits_sign = _sym_bits_row(cdf.cfl_sign[0], 8)
    bits_alpha = np.stack([_sym_bits_row(cdf.cfl_alpha[i], 16)
                           for i in range(6)])
    bits_angle = np.asarray([_sym_bits_row(cdf.angle_delta[i], 7)[3]
                             for i in range(8)], np.float32)
    pbits = _sym_bits_row(cdf.partition[(3 - 1) * 4 + 0], 10)
    part_bits = np.asarray([pbits[0], pbits[3]], np.float32)
    # 16-parent decision (bsl=2) + the four 8-leaf NONE symbols (bsl=1)
    pbits16 = _sym_bits_row(cdf.partition[(2 - 1) * 4 + 0], 10)
    pbits8 = _sym_bits_row(cdf.partition[0], 4)
    part_bits16 = np.asarray(
        [pbits16[0], pbits16[3] + 4 * pbits8[0]], np.float32)
    pbits64 = _sym_bits_row(cdf.partition[(4 - 1) * 4 + 0], 10)
    part_bits64 = np.asarray([pbits64[0], pbits64[3]], np.float32)
    return np.concatenate([part_bits, part_bits16, part_bits64,
                           bits_uv14.ravel(), bits_sign, bits_alpha.ravel(),
                           bits_angle]).astype(np.float32)


def unpack_wavefront(geom, out) -> "WavefrontResult":
    """Host copy of one frame's pass output (int16 records, uint8 recon
    planes, and the inter pass's band tail) as a WavefrontResult."""
    rec16, y, u, v = out[:4]
    packed = np.ascontiguousarray(rec16.cpu().numpy())
    # writable int32 copies: the in-loop filters and the host partial-SB
    # encode mutate these in place
    rec = [p.cpu().numpy().astype(np.int32) for p in (y, u, v)]
    res = _build_result(geom, packed, rec)
    if len(out) > 4:
        # band tail: in-pass ME map + per-level inter RD costs/MVs
        me8, c64, m64, c32, m32, c16, m16 = (
            t.cpu().numpy() for t in out[4])
        i32 = lambda a: a.astype(np.int32)
        res.me_map = i32(me8)
        res.band64 = {"cost": c64, "mv": i32(m64)}
        res.band32 = {"cost": c32, "mv": i32(m32)}
        res.band16 = {"cost": c16, "mv": i32(m16)}
    return res


def _build_result(geom, packed: np.ndarray, rec: list) -> "WavefrontResult":
    """WavefrontResult from a frame's contiguous (K, 4, B, recw) packed
    int16 records + int32 recon planes.  The record width encodes the
    layout: rec_width(True) carries the inter mv nibble fields."""
    K, _, B, recw = packed.shape
    inter = recw == rec_width(True)
    nf = 11 if inter else 7
    mw = 1 + 4 + nf * 21
    meta = packed[..., :mw]
    split_np = meta[..., 0] == 1
    none64_np = meta[:, 0, :, 0] == 2  # quad-0 flag: one 64x64 root block
    f32names = ("mode", "delta", "tt", "skip", "au", "av", "uv")
    if inter:
        f32names = f32names + ("mvrh", "mvrl", "mvch", "mvcl")
    out32_np = {nm: meta[..., 1 + i] for i, nm in enumerate(f32names)}
    s16o = 1 + nf
    split16_np = meta[..., s16o : s16o + 4].transpose(0, 1, 3, 2).astype(bool)
    m16o = s16o + 4
    m16 = meta[..., m16o : m16o + 4 * nf].reshape(
        K, 4, B, 4, nf).transpose(0, 1, 3, 2, 4)
    out16_np = {nm: m16[..., i] for i, nm in enumerate(f32names)}
    m8o = m16o + 4 * nf
    m8 = meta[..., m8o : m8o + 16 * nf].reshape(
        K, 4, B, 4, 4, nf).transpose(0, 1, 3, 4, 2, 5)
    out8_np = {nm: m8[..., i] for i, nm in enumerate(f32names)}
    if inter:
        for o in (out32_np, out16_np, out8_np):
            o["mvr"] = (o.pop("mvrh").astype(np.int32) << 6) + o.pop("mvrl")
            o["mvc"] = (o.pop("mvch").astype(np.int32) << 6) + o.pop("mvcl")
    levels = (packed[..., mw : mw + 1024], packed[..., mw + 1024 : mw + 1280],
              packed[..., mw + 1280 : mw + 1536])
    return WavefrontResult(geom, rec, split_np, out32_np, out16_np, levels,
                           split16_np, out8_np, packed=packed,
                           none64=none64_np, has_mv=inter)
