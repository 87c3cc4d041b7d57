"""Re-derive device reconstruction from the wavefront records with the
numpy oracles (intra_np, mc_np, quantize_np, transforms_np, deblock_np).

A conformance check that needs no decoder: every block record of a device
superblock names its mode, angle delta, tx type and levels (and on inter
frames its motion vector), so prediction from the final pre-filter recon
(for an inter block, mode 13: mc_np from the reference frame's
post-filter recon), dequantisation and the normative inverse transform
must land exactly on the recon the device carried (a chroma block coded
with CFL: the DC prediction, then intra_np's CFL with the coded alpha and
the AC of the block's final luma).  The filtered frame is then held
against the numpy oracles on the same pre-filter planes: deblock_np, then
cdef_np with each superblock's coded strength pair, then loop
restoration with each unit's coded parameters: lrf_np's Wiener filter
with the frame's or the unit's taps, sgr_np's self-guided filter with the
unit's set and projection.
"""

from __future__ import annotations

import numpy as np

from rav1e_tpu_torch.ops import cdef_np as cnp
from rav1e_tpu_torch.ops import deblock_np as dnp
from rav1e_tpu_torch.ops import lrf_np as lnp
from rav1e_tpu_torch.ops import intra_np as ip
from rav1e_tpu_torch.ops import mc_np as mcn
from rav1e_tpu_torch.ops import quantize_np as qz
from rav1e_tpu_torch.ops import sgr_np as sgn
from rav1e_tpu_torch.ops import transforms_np as tn

# DTT4_IDTX set symbol -> tx type (wavefront LUMA_TT)
_TT = {1: tn.DCT_DCT, 2: tn.ADST_ADST, 3: tn.ADST_DCT, 4: tn.DCT_ADST,
       0: tn.IDTX}
# uv mode -> derived chroma tx type (spec Mode_To_Txfm_Type)
_UV_TX = {0: tn.DCT_DCT, 1: tn.ADST_DCT, 2: tn.DCT_ADST, 9: tn.ADST_ADST,
          10: tn.ADST_DCT, 11: tn.DCT_ADST, 12: tn.ADST_ADST, 13: tn.DCT_DCT}
UV_CFL = 13
_QOFF = ((0, 0), (0, 32), (32, 0), (32, 32))
_SOFF = ((0, 0), (0, 16), (16, 0), (16, 16))
_SOFF8 = ((0, 0), (0, 8), (8, 0), (8, 8))


def _block_avail(geom, r, c):
    """(x, y, size) -> (n_top_right, n_bottom_left) of a device SB's 32,
    16 and 8 blocks (the 64x64 root block uses none)."""
    k, li = geom.sb_step[r, c], geom.sb_lane[r, c]
    out = {}
    for q in range(4):
        qy, qx = r * 64 + _QOFF[q][0], c * 64 + _QOFF[q][1]
        out[(qx, qy, 32)] = tuple(geom.avail[k, li, q, 0, 2:4])
        for s in range(4):
            sy, sx = qy + _SOFF[s][0], qx + _SOFF[s][1]
            out[(sx, sy, 16)] = tuple(geom.avail[k, li, q, 1 + s, 2:4])
            for e in range(4):
                out[(sx + _SOFF8[e][1], sy + _SOFF8[e][0], 8)] = tuple(
                    geom.avail8[k, li, q, s, e, 2:4])
    return out


def _recon(plane, x, y, n, mode, ha, hl, delta, ntr, nbl, levels, tx, dcq,
           acq, ref=None, mv=None, sub=0, cfl=None):
    """One block's recon; cfl: (luma AC, alpha) of a CFL chroma block,
    whose mode is then DC."""
    if mode == 13:  # inter, LAST, REGULAR filter
        pred = mcn.put_single(ref, x, y, n, n, int(mv[0]), int(mv[1]), sub,
                              sub, 8)
    else:
        above, left = ip.build_edges(plane, x, y, n, n, bool(ha), bool(hl),
                                     8, n_top_right=int(ntr),
                                     n_bottom_left=int(nbl))
        pred = ip.predict(mode, above, left, n, n, bool(ha), bool(hl),
                          angle_delta=delta)
        if cfl is not None:
            pred = ip.cfl_predict(pred, cfl[0], int(cfl[1]), 8)
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
        (x, y, bw, _bh, mode, _skip, tt, ha, hl, au, av_, delta, uv, lvy,
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
        cfl = mode != 13 and uv == UV_CFL
        cmode = 13 if mode == 13 else (0 if cfl else uv)
        ac = ip.cfl_ac_420(rec[0][y : y + bw, x : x + bw]) if cfl else None
        for p, lvc, alpha in ((1, lvu, au), (2, lvv, av_)):
            lc = _recon(rec[p], x >> 1, y >> 1, cn, cmode, ha, hl, 0, 0, 0,
                        np.asarray(lvc), _UV_TX[uv], dc_q, ac_q, ref(p), mv,
                        1, (ac, alpha) if cfl else None)
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
    per-superblock filtering equals per-superblock decoding); then loop
    restoration of each unit with its coded parameters (_restore)."""
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
        _restore(fe, rec, db)
    return all(np.array_equal(rec[i][: o.shape[0], : o.shape[1]],
                              np.asarray(o)) for i, o in enumerate(recon))


def _restore(fe, rec, db) -> None:
    """Loop restoration of the CDEF output `rec` (in place) from the
    coded unit parameters: luma units Wiener with the frame's or their own
    taps (lrf_np) or SGR with their set and projection (sgr_np); chroma
    units Wiener with their plane's taps.  Every unit reads the CDEF
    output and the deblocked planes `db`, never a restored neighbour."""
    oh, ow = fe.out_h, fe.out_w
    ch, cw = (oh + 1) >> 1, (ow + 1) >> 1
    cd = [p.copy() for p in rec]
    rows = lnp.unit_ranges(64, oh, shifted=True)
    cols = lnp.unit_ranges(64, ow)
    taps_of = lambda v: (tuple(v[1]), tuple(v[2]))
    wiener = [taps_of(v) for v in fe._lr_params.values()
              if v is not None and v[0] == "wiener"]
    # tap sets that serve several units (the frame's): the plane once
    full = {t: lnp.wiener_filter_frame(cd[0], db[0], *t, 64, fe.bd, ow, oh)
            for t in set(wiener) if wiener.count(t) > 1}
    flt = {}
    for (ur, uc), v in fe._lr_params.items():
        if v is None:
            continue
        (y0, y1), (x0, x1) = rows[ur], cols[uc]
        if v[0] == "wiener":
            t = taps_of(v)
            rec[0][y0:y1, x0:x1] = (
                full[t][y0:y1, x0:x1] if t in full else
                lnp.wiener_filter_unit(cd[0], db[0], x0, y0, x1, y1, *t, 64,
                                       fe.bd, ow, oh))
        else:
            _k, si, xqd, _out = v
            if si not in flt:
                flt[si] = sgn.sgr_flt_frame(cd[0], db[0], si, fe.bd, ow, oh)
            f0, f1 = (None if f is None else f[y0:y1, x0:x1]
                      for f in flt[si])
            rec[0][y0:y1, x0:x1] = sgn.sgr_apply(
                cd[0][y0:y1, x0:x1].astype(np.int64), f0, f1, xqd, si, fe.bd)
    rows_c = lnp.unit_ranges(32, ch, shifted=True)
    cols_c = lnp.unit_ranges(32, cw)
    for p in (1, 2):
        if fe.lr_types[p] != 2:
            continue
        rest = lnp.wiener_filter_frame(cd[p], db[p], *fe._lr_chroma_taps[p],
                                       32, fe.bd, cw, ch)
        for (ur, uc), out in fe._lr_chroma[p].items():
            if out is not None:
                sl = (slice(*rows_c[ur]), slice(*cols_c[uc]))
                rec[p][sl] = rest[sl]
