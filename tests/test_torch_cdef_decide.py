"""The CDEF decision of the port (ops/cdef.py decide_plain, the plain
version of K15 cdef_decide) against the JAX package's, on the CPU.

The JAX decision is the tail of cdef_jax._make_search_kernel
(cdef_jax.py:279-299): its jit's __wrapped__ runs op by op, as
tests/test_torch_filters.py runs it, on planes of partial superblocks
(72x136: 2 x 3 superblocks, the last column 8 pixels wide).  The port
decides from the SSE of its own search (K6's plain version), whose sums
are exact where the JAX search sums in f32.  Tolerances:

- use_sb and frame_best equal;
- idx_map equal, or at a superblock where it differs, the two chosen
  costs within f32 rounding of each other (as the search test allows);
- where every candidate ties (flat planes), the first index wins in
  both: exact;
- on a constructed SSE, where the per-superblock total plus the rate
  term equals the frame pair's cost exactly, the strict < keeps the
  frame pair, and one more unit of frame cost flips it: exact, against
  the same JAX lines written out in jnp on that SSE.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.ops import cdef_jax as jcd
from rav1e_tpu_torch.ops import cdef as tcd

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

SEED = 20261018
H, W = 72, 136


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _content(rng, h, w):
    """A source plane (flat patches, edges, noise) and a blurred, noisy
    recon of it: CDEF smooths the noise."""
    lo = rng.integers(30, 226, (h // 16 + 2, w // 16 + 2))
    src = np.kron(lo, np.ones((16, 16)))[:h, :w]
    src = src + 40 * (np.add.outer(np.arange(h), 2 * np.arange(w)) % 37 < 6)
    src = np.clip(src + rng.normal(0, 5, (h, w)), 0, 255)
    rec = (src + np.roll(src, 1, 0) + np.roll(src, 1, 1)) / 3.0
    rec = rec + rng.normal(0, 3, (h, w))
    return (src.astype(np.int32),
            np.clip(np.rint(rec), 0, 255).astype(np.int32))


def _planes(rng):
    sy, y = _content(rng, H, W)
    su, u = _content(rng, H // 2, W // 2)
    sv, v = _content(rng, H // 2, W // 2)
    return y, u, v, sy, su, sv


def _jax_search(planes, skip, sb_lam):
    kern = jcd._make_search_kernel(8, W, H).__wrapped__
    return kern(*(jnp.asarray(a.astype(np.uint16)) for a in planes),
                jnp.asarray(skip), np.float32(sb_lam), damping=3)


def _port_sse(planes, skip):
    y, u, v, sy, su, sv = (_t(a) for a in planes)
    dirs, var = tcd.cdef_dir_plain(y)
    act = tcd.active_blocks(_t(skip), H, W)
    return tcd.cdef_filter_plain(y, u, v, sy, su, sv, dirs, var, act, 3,
                                 tcd.SEARCH)


def _check(got, ref, sse):
    use_sb, frame_best, idx_map = got
    assert use_sb.dtype == torch.bool and use_sb.shape == ()
    assert frame_best.dtype == torch.int32 and frame_best.shape == ()
    assert idx_map.dtype == torch.int32 and idx_map.shape == (2, 3)
    assert bool(use_sb) == bool(ref[0])
    assert int(frame_best) == int(ref[1])
    cost = (sse[:8] + sse[8:][list(tcd.PAIR_UV_IDX)]).numpy()
    jmap = np.asarray(ref[2])
    for r, c in zip(*np.nonzero(idx_map.numpy() != jmap)):
        a, b = cost[idx_map[r, c], r, c], cost[jmap[r, c], r, c]
        assert abs(a - b) <= 2 ** -23 * max(a, b) * 64, (r, c, a, b)


@pytest.mark.parametrize("sb_lam,all_skip", [(0.5, False), (np.inf, False),
                                             (0.5, True)])
def test_decide_matches_jax(sb_lam, all_skip):
    """Noisy planes of partial superblocks; with all_skip the middle
    superblock column's mi are all skip (it counts as not coded)."""
    rng = np.random.default_rng(SEED + int(all_skip))
    planes = _planes(rng)
    skip = rng.random((H // 4, W // 4)) < 0.5
    if all_skip:
        skip[:, 16:32] = True
    ref = _jax_search(planes, skip, sb_lam)
    sse = _port_sse(planes, skip)
    got = tcd.decide_plain(sse, _t(skip), float(np.float32(sb_lam)), H, W)
    _check(got, ref, sse)
    if sb_lam == np.inf:
        assert not bool(got[0])


def test_decide_flat_ties_take_the_first():
    """Flat planes 3 below their source: every candidate filters nothing,
    so all 8 pairs cost the same in every superblock; the first wins each
    argmin in both packages."""
    planes = [np.full((H >> s, W >> s), v, np.int32)
              for s, v in ((0, 100), (1, 90), (1, 80))]
    planes += [p + 3 for p in planes]
    skip = np.zeros((H // 4, W // 4), bool)
    ref = _jax_search(planes, skip, 0.5)
    sse = _port_sse(planes, skip)
    assert bool((sse[:8] == sse[0]).all()) and int(sse[0].min()) > 0
    got = tcd.decide_plain(sse, _t(skip), 0.5, H, W)
    _check(got, ref, sse)
    assert not bool(got[0]) and int(got[1]) == 0
    assert not bool(got[2].any())


def _jax_lines(sse, skip, sb_lam):
    """cdef_jax.py:271-299 written out in jnp on a given SSE."""
    nby, nbx, nsby, nsbx = H // 8, W // 8, -(-H // 64), -(-W // 64)
    sse = jnp.asarray(sse.astype(np.float32))
    cost = sse[:8] + sse[8:][jnp.asarray(tcd.PAIR_UV_IDX)]
    sb_idx = jnp.argmin(cost, axis=0).astype(jnp.int32)
    mi = jnp.asarray(skip)[: nby * 2, : nbx * 2]
    mi = jnp.pad(mi, ((0, nsby * 16 - mi.shape[0]),
                      (0, nsbx * 16 - mi.shape[1])), constant_values=True)
    sb_coded = ~mi.reshape(nsby, 16, nsbx, 16).transpose(0, 2, 1, 3) \
        .reshape(nsby, nsbx, 256).all(axis=2)
    n_coded = sb_coded.sum().astype(jnp.float32)
    frame_cost = cost.sum(axis=(1, 2))
    frame_best = jnp.argmin(frame_cost).astype(jnp.int32)
    persb_total = cost.min(axis=0).sum()
    use_sb = (persb_total + np.float32(sb_lam) * (jcd._SB_HDR_BITS
                                                  + 3.0 * n_coded)
              < frame_cost[frame_best])
    return use_sb, frame_best, jnp.where(use_sb, sb_idx, frame_best)


@pytest.mark.parametrize("extra", [0, 1])
def test_decide_strict_less_than(extra):
    """A constructed SSE: superblock i's least cost 1000 + 10 i at pair
    i % 8, 4 of the 6 superblocks coded, sb_lam 0.5, so the rate term is
    0.5 * (84 + 3 * 4) = 48; pair 0's frame cost is the per-superblock
    total plus 48 + extra.  At extra 0 the per-superblock mode is not
    strictly cheaper (frame pair 0); at 1 it is."""
    nsb = 6
    m = 1000 + 10 * np.arange(nsb)
    best = np.arange(nsb) % 8
    cost = np.repeat(m[None], 8, 0) + 100
    cost[best, np.arange(nsb)] = m
    # pair 0 pays 48 + extra over the superblocks' least costs
    cost[0, 1:] = m[1:] + np.array([10, 10, 10, 10, 8 + extra])
    sse = np.zeros((11, 2, 3), np.int64)
    sse[:8] = cost.reshape(8, 2, 3)
    skip = np.zeros((H // 4, W // 4), bool)
    skip[16:, :] = True      # the lower superblock row: 2 of 3 SBs skip ...
    skip[16:, 32:] = False   # ... the last column's stays coded
    got = tcd.decide_plain(_t(sse), _t(skip), 0.5, H, W)
    ref = _jax_lines(sse, skip, 0.5)
    assert bool(got[0]) == bool(ref[0]) == bool(extra)
    assert int(got[1]) == int(ref[1]) == 0
    assert np.array_equal(got[2].numpy(), np.asarray(ref[2]))
    want = best.reshape(2, 3) if extra else np.zeros((2, 3))
    assert np.array_equal(got[2].numpy(), want)
