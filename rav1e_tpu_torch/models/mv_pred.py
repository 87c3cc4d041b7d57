"""AV1 motion-vector prediction: the ref-MV stack (DRL) construction and the
inter-mode / ref-frame coding contexts, for single and compound reference.

Reference analog: src/context/block_unit.rs (rav1e's ref-MV stack) which
mirrors AV1 spec 7.10.2 "Find MV stack process".  Both the encoder's RD
search and the host entropy pass call this; the decoder re-derives the same
stack, so every rule here is normative (validated bit-exactly against
libdav1d by tests/test_inter_conformance.py).

Scope notes: no temporal MVs (sequence signals enable_ref_frame_mvs=0) and
identity global motion, which is the toolset our frame headers declare.
ZeroMvContext therefore stays 0 (it is only modified by the temporal scan).

Compound support: pass rf as a (fwd, bwd) pair and the stack holds MV
*pairs*; candidates match only when the neighbor's reference pair equals
ours (spec 7.10.2.7 add_ref_mv_candidate, compound arm), and the extra
search builds the combined RefId/RefDiff lists of 7.10.2.12.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# RefFrame enum (spec): 0 = INTRA_FRAME, 1..7 = LAST..ALTREF; -1 = not coded
NONE_FRAME = -1
INTRA_FRAME = 0
LAST_FRAME = 1
LAST2_FRAME = 2
LAST3_FRAME = 3
GOLDEN_FRAME = 4
BWDREF_FRAME = 5
ALTREF2_FRAME = 6
ALTREF_FRAME = 7

MV_BORDER = 128  # eighth-pel units (16 px)
REF_CAT_LEVEL = 640
MAX_REF_MV_STACK_SIZE = 8
MVREF_ROW_COLS = 3


def _is_backward(rf: int) -> bool:
    """spec CheckBackward: BWDREF..ALTREF."""
    return BWDREF_FRAME <= rf <= ALTREF_FRAME


class MiGrid:
    """Per-4x4 mode-info state the MV prediction reads; the encoder writes a
    block's rectangle after coding it (mirroring the decoder's store).  The
    second-reference arrays (ref2/mv2) are NONE/zero for single-ref and
    intra blocks."""

    def __init__(self, mi_rows: int, mi_cols: int):
        self.rows = mi_rows
        self.cols = mi_cols
        self.ref = np.full((mi_rows, mi_cols), NONE_FRAME, np.int32)
        self.ref2 = np.full((mi_rows, mi_cols), NONE_FRAME, np.int32)
        self.mv = np.zeros((mi_rows, mi_cols, 2), np.int32)  # (row, col) 1/8 pel
        self.mv2 = np.zeros((mi_rows, mi_cols, 2), np.int32)
        self.is_newmv = np.zeros((mi_rows, mi_cols), np.bool_)
        self.bw4 = np.zeros((mi_rows, mi_cols), np.int32)  # candidate width in mi
        self.bh4 = np.zeros((mi_rows, mi_cols), np.int32)

    def set_block(self, mi_row, mi_col, bw4, bh4, ref, mv=(0, 0), is_newmv=False,
                  ref2=NONE_FRAME, mv2=(0, 0)):
        r1 = min(mi_row + bh4, self.rows)
        c1 = min(mi_col + bw4, self.cols)
        self.ref[mi_row:r1, mi_col:c1] = ref
        self.ref2[mi_row:r1, mi_col:c1] = ref2
        self.mv[mi_row:r1, mi_col:c1] = mv
        self.mv2[mi_row:r1, mi_col:c1] = mv2
        self.is_newmv[mi_row:r1, mi_col:c1] = is_newmv
        self.bw4[mi_row:r1, mi_col:c1] = bw4
        self.bh4[mi_row:r1, mi_col:c1] = bh4


def lower_mv_precision(mv, allow_hp: bool, force_integer: bool = False):
    """spec 7.10.2.10: candidate MVs rounded to the frame's precision."""
    out = []
    for v in mv:
        v = int(v)
        if force_integer:
            a = abs(v)
            v = (1 if v > 0 else -1) * ((a + 3) & ~7) if a & 7 else v
        elif v & 1:
            v += -1 if v > 0 else 1
        out.append(v)
    return (out[0], out[1]) if not allow_hp else (int(mv[0]), int(mv[1]))


@dataclass
class MvStackResult:
    stack: list  # single: [(mv_row, mv_col)]; compound: [((r0,c0),(r1,c1))]
    weights: list
    num_mv_found: int
    new_mv_context: int  # 0..5
    ref_mv_context: int  # 0..5
    zero_mv_context: int  # 0..1


def drl_ctx(weights, idx: int) -> int:
    """spec: context for the DRL bit between stack entries idx, idx+1."""
    if weights[idx] >= REF_CAT_LEVEL and weights[idx + 1] >= REF_CAT_LEVEL:
        return 0
    if weights[idx] >= REF_CAT_LEVEL and weights[idx + 1] < REF_CAT_LEVEL:
        return 1
    return 2


def find_mv_stack(
    grid: MiGrid,
    mi_row: int,
    mi_col: int,
    bw4: int,
    bh4: int,
    rf,
    allow_hp: bool = False,
    global_mv=(0, 0),
    tile=None,
    sign_bias=None,
) -> MvStackResult:
    """spec 7.10.2 Find MV stack.  rf: a RefFrame id (single prediction) or
    an (rf0, rf1) pair (compound; stack entries become MV pairs).  tile:
    optional (mi_r0, mi_c0, mi_r1, mi_c1) bounds; candidate scans never
    cross them.  sign_bias: {ref_id: 0|1} temporal side per reference (from
    order hints); required for the extra (7.10.2.12) search."""
    is_comp = isinstance(rf, (tuple, list))
    rf0 = int(rf[0]) if is_comp else int(rf)
    rf1 = int(rf[1]) if is_comp else NONE_FRAME
    t_r0, t_c0, t_r1, t_c1 = tile if tile is not None else (0, 0, grid.rows, grid.cols)
    stack: list = []  # always MV pairs internally; [1] is (0,0) for single
    weights: list = []
    state = {"found": False, "newmv_count": 0}

    def is_inside(r: int, c: int) -> bool:
        return t_r0 <= r < t_r1 and t_c0 <= c < t_c1

    def push(cand, weight: int) -> None:
        for i, mv in enumerate(stack):
            if mv == cand:
                weights[i] += weight
                return
        if len(stack) < MAX_REF_MV_STACK_SIZE:
            stack.append(cand)
            weights.append(weight)

    def add_candidate(r: int, c: int, weight: int) -> None:
        """spec 7.10.2.7 add_ref_mv_candidate."""
        cref0 = int(grid.ref[r, c])
        if cref0 <= INTRA_FRAME:
            return
        cref1 = int(grid.ref2[r, c])
        if is_comp:
            if cref0 != rf0 or cref1 != rf1:
                return
            cand = (
                lower_mv_precision(grid.mv[r, c], allow_hp),
                lower_mv_precision(grid.mv2[r, c], allow_hp),
            )
            if grid.is_newmv[r, c]:
                state["newmv_count"] += 1
            state["found"] = True
            push(cand, weight)
        else:
            # each of the neighbor's candidate lists may match independently
            for cref, mvarr in ((cref0, grid.mv), (cref1, grid.mv2)):
                if cref != rf0:
                    continue
                cand = (lower_mv_precision(mvarr[r, c], allow_hp), (0, 0))
                if grid.is_newmv[r, c]:
                    state["newmv_count"] += 1
                state["found"] = True
                push(cand, weight)

    # spanning-candidate weighting (libaom scan_row_mbmi/scan_col_mbmi,
    # matched by dav1d refmvs.c): a neighbor at least as wide/tall as the
    # current block is weighted by how many outer rows/cols it covers
    # (inc), and those outer scans are then skipped (processed_*)
    processed = {"rows": 0, "cols": 0}

    def scan_row(delta_row: int, max_row_offset: int) -> None:
        delta_col = 0
        end4 = min(min(bw4, grid.cols - mi_col), 16)
        use_step16 = bw4 >= 16
        if abs(delta_row) > 1:
            delta_col = 1
            if (mi_col & 1) and bw4 < 2:
                delta_col -= 1
        i = 0
        while i < end4:
            r = mi_row + delta_row
            c = mi_col + delta_col + i
            if not is_inside(r, c):
                break
            cand_bw4 = max(1, int(grid.bw4[r, c]))
            length = min(bw4, cand_bw4)
            if use_step16:
                length = max(4, length)
            elif abs(delta_row) > 1:
                length = max(2, length)
            weight = 2
            if 2 <= bw4 <= cand_bw4:
                inc = min(-max_row_offset + delta_row + 1,
                          max(1, int(grid.bh4[r, c])))
                weight = max(weight, inc)
                processed["rows"] = inc - delta_row - 1
            add_candidate(r, c, length * weight)
            i += length

    def scan_col(delta_col: int, max_col_offset: int) -> None:
        delta_row = 0
        end4 = min(min(bh4, grid.rows - mi_row), 16)
        use_step16 = bh4 >= 16
        if abs(delta_col) > 1:
            delta_row = 1
            if (mi_row & 1) and bh4 < 2:
                delta_row -= 1
        i = 0
        while i < end4:
            r = mi_row + delta_row + i
            c = mi_col + delta_col
            if not is_inside(r, c):
                break
            cand_bh4 = max(1, int(grid.bh4[r, c]))
            length = min(bh4, cand_bh4)
            if use_step16:
                length = max(4, length)
            elif abs(delta_col) > 1:
                length = max(2, length)
            weight = 2
            if 2 <= bh4 <= cand_bh4:
                inc = min(-max_col_offset + delta_col + 1,
                          max(1, int(grid.bw4[r, c])))
                weight = max(weight, inc)
                processed["cols"] = inc - delta_col - 1
            add_candidate(r, c, length * weight)
            i += length

    def scan_point(delta_row: int, delta_col: int) -> None:
        r = mi_row + delta_row
        c = mi_col + delta_col
        if is_inside(r, c) and grid.ref[r, c] != NONE_FRAME:
            add_candidate(r, c, 4)

    found_above = False
    found_left = False

    # maximum scan offsets, clamped at the tile edge (libaom
    # find_valid_row_offset / find_valid_col_offset); these also feed the
    # spanning-candidate weight above
    max_row_offset = 0
    if mi_row > t_r0:
        max_row_offset = max(-(MVREF_ROW_COLS << 1), t_r0 - mi_row)
    max_col_offset = 0
    if mi_col > t_c0:
        max_col_offset = max(-(MVREF_ROW_COLS << 1), t_c0 - mi_col)

    state["found"] = False
    if abs(max_row_offset) >= 1:
        scan_row(-1, max_row_offset)
    found_above |= state["found"]

    state["found"] = False
    if abs(max_col_offset) >= 1:
        scan_col(-1, max_col_offset)
    found_left |= state["found"]

    state["found"] = False
    if bw4 <= 16:  # top-right point only for blocks narrow enough (spec)
        scan_point(-1, bw4)
    found_above |= state["found"]

    close_matches = int(found_above) + int(found_left)
    num_nearest = len(stack)
    num_new = state["newmv_count"]
    for i in range(num_nearest):
        weights[i] += REF_CAT_LEVEL
    zero_mv_context = 0  # temporal-MV scan disabled (enable_ref_frame_mvs=0)

    state["found"] = False
    scan_point(-1, -1)
    found_above |= state["found"]

    for idx in range(2, MVREF_ROW_COLS + 1):
        delta = -(idx * 2 - 1)
        state["found"] = False
        if (abs(delta) <= abs(max_row_offset)
                and abs(delta) > processed["rows"]):
            scan_row(delta, max_row_offset)
        found_above |= state["found"]
        state["found"] = False
        if (abs(delta) <= abs(max_col_offset)
                and abs(delta) > processed["cols"]):
            scan_col(delta, max_col_offset)
        found_left |= state["found"]

    total_matches = int(found_above) + int(found_left)

    # stable descending sort: nearest group then outer group
    def sort_range(lo: int, hi: int) -> None:
        order = sorted(range(lo, hi), key=lambda i: -weights[i])
        stack[lo:hi] = [stack[i] for i in order]
        weights[lo:hi] = [weights[i] for i in order]

    sort_range(0, num_nearest)
    sort_range(num_nearest, len(stack))

    if close_matches == 0:
        new_mv_context = min(total_matches, 1)  # 0, 1
        ref_mv_context = total_matches  # 0, 1, 2
    elif close_matches == 1:
        new_mv_context = 3 - min(num_new, 1)  # 2, 3
        ref_mv_context = 2 + total_matches  # 3, 4
    else:
        new_mv_context = 5 - min(num_new, 1)  # 4, 5
        ref_mv_context = 5

    # extra search (spec 7.10.2.12): with fewer than 2 candidates, sweep the
    # nearest above row / left column once more accepting candidates of ANY
    # reference, sign-flipping MVs whose ref lies on the other temporal side.
    # Both passes are bounded by min(w4, h4) (libaom mi_size = min(w,h)).
    if len(stack) < 2:
        sb_map = sign_bias or {}
        w4 = min(min(bw4, grid.cols - mi_col), 16)
        h4 = min(min(bh4, grid.rows - mi_row), 16)
        num4 = min(w4, h4)
        ref_id_mvs = ([], [])  # compound: per-list matching-ref candidates
        ref_diff_mvs = ([], [])

        def add_extra(r: int, c: int) -> None:
            for cref, mvarr in ((int(grid.ref[r, c]), grid.mv),
                                (int(grid.ref2[r, c]), grid.mv2)):
                if cref <= INTRA_FRAME:
                    continue
                mv = (int(mvarr[r, c, 0]), int(mvarr[r, c, 1]))
                if is_comp:
                    for li, lrf in enumerate((rf0, rf1)):
                        if cref == lrf and len(ref_id_mvs[li]) < 2:
                            ref_id_mvs[li].append(mv)
                        elif len(ref_diff_mvs[li]) < 2:
                            m2 = mv
                            if sb_map.get(cref, 0) != sb_map.get(lrf, 0):
                                m2 = (-mv[0], -mv[1])
                            ref_diff_mvs[li].append(m2)
                else:
                    if sb_map.get(cref, 0) != sb_map.get(rf0, 0):
                        mv = (-mv[0], -mv[1])
                    mv = lower_mv_precision(mv, allow_hp)
                    cand = (mv, (0, 0))
                    if cand not in stack and len(stack) < 2:
                        stack.append(cand)
                        weights.append(2)

        for pass_ in range(2):
            if pass_ == 0:
                if mi_row <= t_r0:
                    continue
            else:
                if mi_col <= t_c0:
                    continue
            i = 0
            while i < num4 and (is_comp or len(stack) < 2):
                if pass_ == 0:
                    r, c = mi_row - 1, mi_col + i
                else:
                    r, c = mi_row + i, mi_col - 1
                if not is_inside(r, c):
                    break
                add_extra(r, c)
                i += max(1, int(grid.bw4[r, c] if pass_ == 0 else grid.bh4[r, c]))

        if is_comp:
            combined = []
            for k in range(2):
                entry = []
                for li in range(2):
                    pool = ref_id_mvs[li] + ref_diff_mvs[li]
                    entry.append(pool[k] if k < len(pool)
                                 else (int(global_mv[0]), int(global_mv[1])))
                combined.append((entry[0], entry[1]))
            if len(stack) == 1:
                if combined[0] == stack[0]:
                    stack.append(combined[1])
                else:
                    stack.append(combined[0])
                weights.append(2)
            elif len(stack) == 0:
                stack.extend(combined)
                weights.extend([2, 2])

    num_mv_found = len(stack)
    while len(stack) < 2:
        gmv = (int(global_mv[0]), int(global_mv[1]))
        stack.append((gmv, gmv if is_comp else (0, 0)))
        weights.append(0)

    # clamp (spec 7.10.2.14)
    row_border = MV_BORDER + bh4 * 32
    col_border = MV_BORDER + bw4 * 32
    mb_top = -(mi_row * 32)
    mb_bottom = (grid.rows - bh4 - mi_row) * 32
    mb_left = -(mi_col * 32)
    mb_right = (grid.cols - bw4 - mi_col) * 32

    def clamp1(mv):
        r = max(mb_top - row_border, min(mb_bottom + row_border, mv[0]))
        c = max(mb_left - col_border, min(mb_right + col_border, mv[1]))
        return (r, c)

    for i in range(len(stack)):
        m0, m1 = stack[i]
        stack[i] = (clamp1(m0), clamp1(m1)) if is_comp else clamp1(m0)

    return MvStackResult(
        stack=stack,
        weights=weights,
        num_mv_found=num_mv_found,
        new_mv_context=new_mv_context,
        ref_mv_context=ref_mv_context,
        zero_mv_context=zero_mv_context,
    )


# -- neighbor-derived coding contexts ----------------------------------------


def intra_inter_ctx(grid: MiGrid, mi_row: int, mi_col: int, tile=None) -> int:
    """Context for the is_inter bit (libaom av1_get_intra_inter_context)."""
    t_r0, t_c0 = (tile[0], tile[1]) if tile is not None else (0, 0)
    has_above = mi_row > t_r0
    has_left = mi_col > t_c0
    above_intra = has_above and grid.ref[mi_row - 1, mi_col] == INTRA_FRAME
    left_intra = has_left and grid.ref[mi_row, mi_col - 1] == INTRA_FRAME
    if has_above and has_left:
        if above_intra and left_intra:
            return 3
        return 1 if (above_intra or left_intra) else 0
    if has_above or has_left:
        return 2 * int(above_intra or left_intra)
    return 0


def neighbor_ref_counts(grid: MiGrid, mi_row: int, mi_col: int, tile=None) -> np.ndarray:
    """Counts of each RefFrame among the direct above/left neighbors (both
    references of a compound neighbor count)."""
    t_r0, t_c0 = (tile[0], tile[1]) if tile is not None else (0, 0)
    counts = np.zeros(8, np.int32)
    for ok, r, c in ((mi_row > t_r0, mi_row - 1, mi_col),
                     (mi_col > t_c0, mi_row, mi_col - 1)):
        if not ok:
            continue
        for ref in (int(grid.ref[r, c]), int(grid.ref2[r, c])):
            if ref > INTRA_FRAME:
                counts[ref] += 1
    return counts


def _balance_ctx(c0: int, c1: int) -> int:
    return 1 if c0 == c1 else (0 if c0 < c1 else 2)


def single_ref_ctxs(counts: np.ndarray) -> dict:
    """Contexts for single_ref_p1..p6 (libaom av1_get_pred_context_*)."""
    fwd = int(counts[LAST_FRAME] + counts[LAST2_FRAME] + counts[LAST3_FRAME] + counts[GOLDEN_FRAME])
    bwd = int(counts[BWDREF_FRAME] + counts[ALTREF2_FRAME] + counts[ALTREF_FRAME])
    return {
        1: _balance_ctx(fwd, bwd),
        2: _balance_ctx(int(counts[BWDREF_FRAME] + counts[ALTREF2_FRAME]), int(counts[ALTREF_FRAME])),
        3: _balance_ctx(int(counts[LAST_FRAME] + counts[LAST2_FRAME]), int(counts[LAST3_FRAME] + counts[GOLDEN_FRAME])),
        4: _balance_ctx(int(counts[LAST_FRAME]), int(counts[LAST2_FRAME])),
        5: _balance_ctx(int(counts[LAST3_FRAME]), int(counts[GOLDEN_FRAME])),
        6: _balance_ctx(int(counts[BWDREF_FRAME]), int(counts[ALTREF2_FRAME])),
    }


# -- compound-reference coding contexts ---------------------------------------


def _neighbor_info(grid: MiGrid, r: int, c: int) -> tuple:
    """(is_inter, ref0, ref1, has_second, is_unidir) for a coded neighbor."""
    ref0 = int(grid.ref[r, c])
    ref1 = int(grid.ref2[r, c])
    has_second = ref1 > INTRA_FRAME
    uni = has_second and (_is_backward(ref0) == _is_backward(ref1))
    return (ref0 != INTRA_FRAME and ref0 != NONE_FRAME, ref0, ref1, has_second, uni)


def comp_mode_ctx(grid: MiGrid, mi_row: int, mi_col: int, tile=None) -> int:
    """Context for the comp_mode (single vs compound) symbol, libaom
    av1_get_reference_mode_context / spec comp_mode contexts."""
    t_r0, t_c0 = (tile[0], tile[1]) if tile is not None else (0, 0)
    has_above = mi_row > t_r0
    has_left = mi_col > t_c0
    if has_above and has_left:
        a_inter, a0, _, a2nd, _ = _neighbor_info(grid, mi_row - 1, mi_col)
        l_inter, l0, _, l2nd, _ = _neighbor_info(grid, mi_row, mi_col - 1)
        if not a2nd and not l2nd:
            return int(_is_backward(a0)) ^ int(_is_backward(l0))
        if not a2nd:
            return 2 + int(_is_backward(a0) or not a_inter)
        if not l2nd:
            return 2 + int(_is_backward(l0) or not l_inter)
        return 4
    if has_above or has_left:
        r, c = (mi_row - 1, mi_col) if has_above else (mi_row, mi_col - 1)
        _, e0, _, e2nd, _ = _neighbor_info(grid, r, c)
        return 3 if e2nd else int(_is_backward(e0))
    return 1


def comp_ref_type_ctx(grid: MiGrid, mi_row: int, mi_col: int, tile=None) -> int:
    """Context for comp_ref_type (unidir vs bidir pair), libaom
    av1_get_comp_reference_type_context.  The unidir/unidir arm is
    unreachable from this encoder's emitted toolset (we only code bidir
    pairs) but is kept for completeness."""
    t_r0, t_c0 = (tile[0], tile[1]) if tile is not None else (0, 0)
    has_above = mi_row > t_r0
    has_left = mi_col > t_c0
    if has_above and has_left:
        a_inter, a0, _, a2nd, a_uni = _neighbor_info(grid, mi_row - 1, mi_col)
        l_inter, l0, _, l2nd, l_uni = _neighbor_info(grid, mi_row, mi_col - 1)
        if not a_inter and not l_inter:
            return 2
        if a_inter != l_inter:  # intra/inter
            _, e0, _, e2nd, e_uni = (
                _neighbor_info(grid, mi_row, mi_col - 1) if not a_inter
                else _neighbor_info(grid, mi_row - 1, mi_col))
            if not e2nd:
                return 2
            return 1 + 2 * int(e_uni)
        if not a2nd and not l2nd:  # single/single
            return 1 + 2 * int(_is_backward(a0) == _is_backward(l0))
        if not a2nd or not l2nd:  # single/comp
            uni = a_uni if a2nd else l_uni
            if not uni:
                return 1
            return 3 + int(_is_backward(a0) == _is_backward(l0))
        # comp/comp
        if not a_uni and not l_uni:
            return 0
        if not a_uni or not l_uni:
            return 2
        return 3 + int((a0 == BWDREF_FRAME) == (l0 == BWDREF_FRAME))
    if has_above or has_left:
        r, c = (mi_row - 1, mi_col) if has_above else (mi_row, mi_col - 1)
        e_inter, _, _, e2nd, e_uni = _neighbor_info(grid, r, c)
        if not e_inter:
            return 2
        if not e2nd:
            return 2
        return 4 * int(e_uni)
    return 2
