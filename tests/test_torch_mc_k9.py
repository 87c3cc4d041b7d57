"""K9's residual and two-plane modes (ops/mc.py mc_block_batch_plain, the
plain version of csrc/mc_pred.cu) against the JAX package's
mc_jax.mc_block_batch, on the CPU.

The inter race calls K9 with the source plane: it returns src - the
prediction for every candidate of every block (the candidates of a block
share its position, `cands`), and for the winner's chroma U and V in one
call, the prediction and the residual.  The JAX package predicts each
plane and subtracts.  The same numpy planes, positions and MVs go to both
(the JAX function runs op by op, unjitted), at n = 8 to 64, 8, 10 and 12
bits, the REGULAR and SHARP filter sets, with blocks at the plane's
corners and MVs at +-MV_LIMIT, where the window reaches the margin's
edge.  Everything is integer arithmetic: the tolerance is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.ops import mc_jax as jmc
from rav1e_tpu_torch.ops import mc as tmc

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

SEED = 20261018
REGULAR, SHARP = 0, 2
CANDS = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(rng, n, bd, sub):
    """A plane of 3 x 4 blocks of n (this plane's subsampling), its
    source, the padded reference and every block's position, with MVs
    (luma space) at the limits on the corner blocks."""
    rh, rw = 3 * n, 4 * n
    ref = rng.integers(0, 1 << bd, (rh, rw)).astype(np.int32)
    src = rng.integers(0, 1 << bd, (rh, rw)).astype(np.int32)
    pad = tmc.pad_ref_plane(ref, tmc.MC_MARGIN, rh, rw)
    py, px = (a.ravel().astype(np.int32) * n for a in np.mgrid[0:3, 0:4])
    lim = tmc.MV_LIMIT
    mv = rng.integers(-lim, lim + 1, (px.size * CANDS, 2)).astype(np.int32)
    # corner blocks: their candidates reach the margin in each direction
    for b, (r, c) in zip((0, 3, 8, 11), ((-lim, -lim), (-lim, lim),
                                         (lim, -lim), (lim, lim))):
        mv[b * CANDS] = (r, c)
    return pad, src, px, py, mv


def _jax_pred(pad, px, py, mv, n, sub, bd, fset):
    taps = jnp.asarray(tmc.filter_taps(fset))
    return np.asarray(jmc.mc_block_batch(
        jnp.asarray(pad), tmc.MC_MARGIN, jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(mv[:, 0]), jnp.asarray(mv[:, 1]), n, n, sub, sub, bd,
        taps, taps))


def _blocks(src, px, py, n):
    return np.stack([src[y : y + n, x : x + n] for x, y in zip(px, py)])


@pytest.mark.parametrize("n,bd,fset", [(8, 8, REGULAR), (16, 10, SHARP),
                                       (32, 12, REGULAR), (64, 8, SHARP),
                                       (16, 8, REGULAR), (32, 10, SHARP),
                                       (64, 12, REGULAR), (8, 12, SHARP)])
def test_residual_mode_matches_jax(n, bd, fset):
    """The race: CANDS candidates a block, the source read at the block's
    position; the residual equals the JAX source block minus the JAX
    prediction, through the plain version and the wrapper on CPU
    tensors."""
    rng = np.random.default_rng(SEED + n + bd + fset)
    pad, src, px, py, mv = _case(rng, n, bd, 0)
    rep = lambda a: np.repeat(a, CANDS)
    want = (np.repeat(_blocks(src, px, py, n), CANDS, 0)
            - _jax_pred(pad, rep(px), rep(py), mv, n, 0, bd, fset))
    args = (_t(pad), tmc.MC_MARGIN, _t(px), _t(py), _t(mv[:, 0]),
            _t(mv[:, 1]), n, n, 0, 0, bd, tmc.filter_taps(fset))
    got = tmc.mc_block_batch_plain(*args, src=_t(src), cands=CANDS)
    assert got.dtype == torch.int32 and got.shape == (px.size * CANDS, n, n)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(tmc.mc_block_batch(*args, src=_t(src), cands=CANDS),
                       got)
    # the prediction it stands for: src - residual
    pred = tmc.mc_block_batch_plain(*args, cands=CANDS)
    assert torch.equal(pred, _t(np.repeat(_blocks(src, px, py, n), CANDS, 0))
                       - got)


@pytest.mark.parametrize("n,bd,fset", [(4, 8, REGULAR), (8, 8, SHARP),
                                       (16, 10, REGULAR), (32, 12, SHARP),
                                       (32, 8, REGULAR)])
def test_two_plane_mode_matches_jax(n, bd, fset):
    """U and V in one call (4:2:0 chroma of n x n, sub 1, the same
    positions and luma-space MVs): the prediction, the residual and both,
    each (N, 2, n, n), equal the JAX planes stacked."""
    rng = np.random.default_rng(SEED + 7 * n + bd + fset)
    pu, su, px, py, mv = _case(rng, n, bd, 1)
    pv, sv, *_ = _case(rng, n, bd, 1)
    rep = lambda a: np.repeat(a, CANDS)
    jp = np.stack([_jax_pred(p, rep(px), rep(py), mv, n, 1, bd, fset)
                   for p in (pu, pv)], 1)
    js = np.repeat(np.stack([_blocks(s, px, py, n) for s in (su, sv)], 1),
                   CANDS, 0)
    args = ((_t(pu), _t(pv)), tmc.MC_MARGIN, _t(rep(px)), _t(rep(py)),
            _t(mv[:, 0]), _t(mv[:, 1]), n, n, 1, 1, bd,
            tmc.filter_taps(fset))
    pred = tmc.mc_block_batch_plain(*args)
    assert pred.shape == (px.size * CANDS, 2, n, n)
    assert np.array_equal(pred.numpy(), jp)
    resid = tmc.mc_block_batch_plain(*args, src=(_t(su), _t(sv)))
    assert np.array_equal(resid.numpy(), js - jp)
    p2, r2 = tmc.mc_block_batch(*args, src=(_t(su), _t(sv)), both=True)
    assert torch.equal(p2, pred) and torch.equal(r2, resid)
