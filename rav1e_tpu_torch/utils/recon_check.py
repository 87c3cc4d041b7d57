"""Re-derive device reconstruction from the wavefront records with the
numpy oracles (intra_np, mc_np, quantize_np, transforms_np, deblock_np).

A conformance check that needs no decoder: every block record of a device
superblock names its mode, angle delta, tx type and levels (and on inter
frames its motion vector), so prediction from the final pre-filter recon
(for an inter block, mode 13: mc_np from the reference frame's
post-filter recon), dequantisation and the normative inverse transform
must land exactly on the recon the device carried.  The
filtered frame is then held against the numpy oracles on the same
pre-filter planes: deblock_np, then cdef_np with each superblock's coded
strength pair, then lrf_np's Wiener filter with the coded taps on the
units that chose it.
"""

from __future__ import annotations

import numpy as np

from rav1e_tpu_torch.ops import cdef_np as cnp
from rav1e_tpu_torch.ops import deblock_np as dnp
from rav1e_tpu_torch.ops import lrf_np as lnp
from rav1e_tpu_torch.ops import intra_np as ip
from rav1e_tpu_torch.ops import mc_np as mcn
from rav1e_tpu_torch.ops import quantize_np as qz
from rav1e_tpu_torch.ops import transforms_np as tn

# DTT4_IDTX set symbol -> tx type (wavefront LUMA_TT)
_TT = {1: tn.DCT_DCT, 2: tn.ADST_ADST, 3: tn.ADST_DCT, 4: tn.DCT_ADST,
       0: tn.IDTX}
# uv mode -> derived chroma tx type (spec Mode_To_Txfm_Type)
_UV_TX = {0: tn.DCT_DCT, 1: tn.ADST_DCT, 2: tn.DCT_ADST, 9: tn.ADST_ADST,
          10: tn.ADST_DCT, 11: tn.DCT_ADST, 12: tn.ADST_ADST}
_QOFF = ((0, 0), (0, 32), (32, 0), (32, 32))
_SOFF = ((0, 0), (0, 16), (16, 0), (16, 16))


def _block_avail(geom, r, c):
    """(x, y, size) -> (n_top_right, n_bottom_left) of a device SB's 32 and
    16 blocks (the 64x64 root block uses none)."""
    k, li = geom.sb_step[r, c], geom.sb_lane[r, c]
    out = {}
    for q in range(4):
        qy, qx = r * 64 + _QOFF[q][0], c * 64 + _QOFF[q][1]
        out[(qx, qy, 32)] = tuple(geom.avail[k, li, q, 0, 2:4])
        for s in range(4):
            out[(qx + _SOFF[s][1], qy + _SOFF[s][0], 16)] = tuple(
                geom.avail[k, li, q, 1 + s, 2:4])
    return out


def _recon(plane, x, y, n, mode, ha, hl, delta, ntr, nbl, levels, tx, dcq,
           acq, ref=None, mv=None, sub=0):
    if mode == 13:  # inter, LAST, REGULAR filter
        pred = mcn.put_single(ref, x, y, n, n, int(mv[0]), int(mv[1]), sub,
                              sub, 8)
    else:
        above, left = ip.build_edges(plane, x, y, n, n, bool(ha), bool(hl),
                                     8, n_top_right=int(ntr),
                                     n_bottom_left=int(nbl))
        pred = ip.predict(mode, above, left, n, n, bool(ha), bool(hl),
                          angle_delta=delta)
    lv = np.zeros((n, n), np.int32)
    m = levels.shape[0]
    lv[:m, :m] = levels
    dq = qz.dequantize(lv, dcq, acq, n, n)
    return np.clip(pred + tn.inverse_transform(dq, tx), 0, 255)


def rederive_sb(wf, rec, r: int, c: int, dc_q: int, ac_q: int,
                refs=None) -> bool:
    """Whether every block of device SB (r, c) re-derives exactly onto the
    pre-filter recon planes `rec` [Y, U, V].  refs: the LAST reference's
    post-filter recon [Y, U, V] at the real frame size (inter frames)."""
    av = _block_avail(wf.geom, r, c)
    for rec_ in wf.sb_records(r, c):
        (x, y, bw, _bh, mode, _skip, tt, ha, hl, _au, _av, delta, uv, lvy,
         lvu, lvv) = rec_[:16]
        mv = rec_[16:18] if mode == 13 else None
        ref = (lambda p: refs[p]) if mode == 13 else (lambda p: None)
        ntr, nbl = av.get((x, y, bw), (0, 0))
        ly = _recon(rec[0], x, y, bw, mode, ha, hl, delta, ntr, nbl,
                    np.asarray(lvy), tn.DCT_DCT if bw == 64 else _TT[tt],
                    dc_q, ac_q, ref(0), mv)
        if not np.array_equal(ly, rec[0][y : y + bw, x : x + bw]):
            return False
        cn = bw >> 1
        cmode = 13 if mode == 13 else uv
        for p, lvc in ((1, lvu), (2, lvv)):
            lc = _recon(rec[p], x >> 1, y >> 1, cn, cmode, ha, hl, 0, 0, 0,
                        np.asarray(lvc), _UV_TX[uv], dc_q, ac_q, ref(p), mv,
                        1)
            if not np.array_equal(lc, rec[p][y >> 1 : (y >> 1) + cn,
                                             x >> 1 : (x >> 1) + cn]):
                return False
    return True


def _pair(y_code: int, uv_code: int) -> tuple:
    """(y_pri, y_sec, uv_pri, uv_sec) of coded CDEF strength codes."""
    sec = (0, 1, 2, 4)
    return (y_code >> 2, sec[y_code & 3], uv_code >> 2, sec[uv_code & 3])


def filters_match(fe, prefilter, recon) -> bool:
    """Whether the numpy oracles over the pre-filter planes give the
    encoder's output recon (cropped planes): deblock_np; then, per 64x64
    superblock, cdef_np.cdef_frame_batched with the superblock's coded
    strength pair (over the whole frame when one pair serves it, else over
    each superblock with a margin: CDEF reads only deblocked samples, so
    per-superblock filtering equals per-superblock decoding); then
    lrf_np.wiener_filter_frame with the coded taps, composed on the units
    that chose Wiener."""
    h, w = fe.coded_h, fe.coded_w
    rec = [p.copy() for p in prefilter]
    dnp.deblock_frame(rec, fe.db_info, fe.lf_levels, fe.lf_sharpness, fe.bd,
                      w, h)
    db = [p.copy() for p in rec]
    if fe.cdef_strengths is not None:
        nsby, nsbx = -(-h // 64), -(-w // 64)
        if fe.cdef_sb is not None:
            _bits, y_codes, uv_codes, idx_map = fe.cdef_sb
        else:
            y_codes, uv_codes = (fe.cdef_strengths[0],), (fe.cdef_strengths[1],)
            idx_map = np.zeros((nsby, nsbx), np.int32)
        used = np.unique(idx_map)
        if len(used) == 1:
            k = int(used[0])
            cnp.cdef_frame_batched(rec, fe.db_info.skip,
                                   *_pair(y_codes[k], uv_codes[k]),
                                   fe.cdef_damping, fe.bd, w, h)
        else:
            for r, c in np.ndindex(*idx_map.shape):
                # the superblock with an 8-px margin of real neighbours (its
                # taps reach 2 px); the frame's own edges stay edges
                y0, y1 = max(0, r * 64 - 8), min(h, r * 64 + 72)
                x0, x1 = max(0, c * 64 - 8), min(w, c * 64 + 72)
                crop = [db[p][y0 >> (p > 0) : y1 >> (p > 0),
                              x0 >> (p > 0) : x1 >> (p > 0)].copy()
                        for p in range(3)]
                k = int(idx_map[r, c])
                cnp.cdef_frame_batched(crop, fe.db_info.skip[y0 >> 2 : y1 >> 2,
                                                             x0 >> 2 : x1 >> 2],
                                       *_pair(y_codes[k], uv_codes[k]),
                                       fe.cdef_damping, fe.bd, x1 - x0, y1 - y0)
                for p in range(3):
                    s_ = 1 if p else 0
                    b = 64 >> s_
                    oy, ox = (r * 64 - y0) >> s_, (c * 64 - x0) >> s_
                    rec[p][r * b : (r + 1) * b, c * b : (c + 1) * b] = \
                        crop[p][oy : oy + b, ox : ox + b]
    if fe.lrf:
        oh, ow = fe.out_h, fe.out_w
        ch, cw = (oh + 1) >> 1, (ow + 1) >> 1
        units = {0: {k: v is not None for k, v in fe._lr_params.items()}}
        taps = {}
        for k, v in fe._lr_params.items():
            if v is not None:
                taps[0] = (v[1], v[2])
        for p in (1, 2):
            if fe.lr_types[p] == 2:
                units[p] = {k: v is not None
                            for k, v in fe._lr_chroma[p].items()}
                taps[p] = fe._lr_chroma_taps[p]
        for p, (hh, ww, unit) in enumerate(((oh, ow, 64), (ch, cw, 32),
                                            (ch, cw, 32))):
            if p not in taps:
                continue
            rest = lnp.wiener_filter_frame(rec[p], db[p], *taps[p], unit,
                                           fe.bd, ww, hh)
            rows = lnp.unit_ranges(unit, hh, shifted=True)
            cols = lnp.unit_ranges(unit, ww)
            for (ur, uc), on in units[p].items():
                if on:
                    sl = (slice(*rows[ur]), slice(*cols[uc]))
                    rec[p][sl] = rest[sl]
    return all(np.array_equal(rec[i][: o.shape[0], : o.shape[1]],
                              np.asarray(o)) for i, o in enumerate(recon))
