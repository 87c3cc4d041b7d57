"""K1 intra_pred's modes against the JAX package, on the CPU.

The wrapper (rav1e_tpu_torch/ops/intra.py intra_pred) runs its plain
version for CPU tensors; the same numpy inputs, made from one seed, go
through it and through the JAX functions it replaces.  Intra prediction
is normative and integer: the tolerance is zero everywhere.

- List mode: any channel list of the FULL enumeration equals the FULL
  set's slices, and FULL equals intra_jax's dc_predict, predict_dirs and
  the stack's non-directional predictions; two planes in one call equal
  two calls.
- Race mode: the key pass's fine-direction pick, held to the JAX pass's
  own lines (rav1e_tpu/models/wavefront.py:623-631, written out below in
  jnp): the SAD of each of the 56 directional variants against the
  source, the first least among each base direction's allowed deltas
  (zone 1 barred where allow_z1 is false), the 13-candidate stack.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.ops import intra_jax as ij
from rav1e_tpu_torch.ops import intra as ti

torch.set_num_threads(1)

SEED = 20261018
BIG = 1 << 30


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _edges(rng, B, n, flat=False):
    if flat:  # every edge sample equal: the directional variants tie
        v = rng.integers(0, 256, (B, 1))
        above = np.repeat(v, 2 * n + 1, 1).astype(np.int32)
    else:
        above = rng.integers(0, 256, (B, 2 * n + 1)).astype(np.int32)
    left = (above.copy() if flat
            else rng.integers(0, 256, (B, 2 * n + 1)).astype(np.int32))
    left[:, 0] = above[:, 0]
    return above, left, rng.random(B) < 0.7, rng.random(B) < 0.7


@jax.jit
def _jax_modes(above, left, ha, hl):
    """predict_dirs (B, 8, 7, n, n), dc_predict (B, n, n) and predict_stack
    (B, 13, n, n) of intra_jax."""
    n = (above.shape[1] - 1) // 2
    return (ij.predict_dirs(above, left, n),
            ij.dc_predict(above, left, n, n, ha, hl),
            ij.predict_stack(above, left, n, n, ha, hl))


@jax.jit
def _jax_race(above, left, ha, hl, src, allow_z1):
    """The JAX pass's fine-direction pick (wavefront.py:614-631)."""
    n = (above.shape[1] - 1) // 2
    dirs = ij.predict_dirs(above, left, n)
    dc = ij.dc_predict(above, left, n, n, ha, hl)
    nd = ij.predict_stack(above, left, n, n, ha, hl)[:, 9:13]
    sad56 = jnp.abs(dirs - src[:, None, None]).sum((-1, -2))  # (B,8,7)
    angs56 = jnp.asarray(ij.DIR_ANGLES)  # (8, 7) static angle table
    bad56 = (angs56[None] < 90) & ~allow_z1[:, None, None]
    di8 = jnp.argmin(jnp.where(bad56, jnp.int32(BIG), sad56), axis=2)  # (B, 8)
    dir_cand = jnp.take_along_axis(
        dirs, di8[:, :, None, None, None], axis=2)[:, :, 0]
    return jnp.concatenate([dc[:, None], dir_cand, nd], axis=1), di8


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_full_set_matches_jax(n):
    rng = np.random.default_rng(SEED + n)
    above, left, ha, hl = _edges(rng, 6, n)
    got = ti.intra_pred(_t(above), _t(left), _t(ha), _t(hl), n, True).numpy()
    dirs, dc, stack = (np.asarray(v) for v in _jax_modes(above, left, ha, hl))
    assert got.shape == (6, ti.N_FULL, n, n)
    assert np.array_equal(got[:, 0], dc)
    assert np.array_equal(got[:, 1:57].reshape(6, 8, 7, n, n), dirs)
    assert np.array_equal(got[:, 57:61], stack[:, 9:13])


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_channel_lists_are_full_slices(n):
    """NONDIR, the 13 modes at delta 0, the band maps' 10 candidates, DC
    alone and a shuffled list with repeats: each the FULL set's slice;
    the delta-0 stack is also predict_stack's."""
    rng = np.random.default_rng(SEED + 10 + n)
    above, left, ha, hl = _edges(rng, 5, n)
    args = (_t(above), _t(left), _t(ha), _t(hl), n)
    full = ti.intra_pred(*args, True).numpy()
    lists = (ti.NONDIR_CHANNELS, ti.STACK13_CHANNELS,
             (0, 4, 11, 57, 58, 59, 60, 25, 32, 39), (0,),
             tuple(rng.integers(0, ti.N_FULL, 20)))
    for chans in lists:
        got = ti.intra_pred(*args, True, channels=chans).numpy()
        assert np.array_equal(got, full[:, list(chans)]), chans
    assert np.array_equal(ti.intra_pred(*args, False).numpy(),
                          full[:, list(ti.NONDIR_CHANNELS)])
    stack = np.asarray(_jax_modes(above, left, ha, hl)[2])
    got = ti.intra_pred(*args, True, channels=ti.STACK13_CHANNELS).numpy()
    assert np.array_equal(got, stack)


@pytest.mark.parametrize("n,chans", [(4, ti.NONDIR_CHANNELS),
                                     (8, ti.NONDIR_CHANNELS[:1]),
                                     (16, ti.NONDIR_CHANNELS),
                                     (32, (0,))])
def test_two_planes_in_one_call(n, chans):
    """U and V in one call: (B, 2, nch, n, n), each plane the call on its
    own edges (the chroma race, the 64x64 root's chroma DC)."""
    rng = np.random.default_rng(SEED + 20 + n)
    aU, lU, ha, hl = _edges(rng, 4, n)
    aV, lV, _, _ = _edges(rng, 4, n)
    fl = (_t(ha), _t(hl))
    got = ti.intra_pred((_t(aU), _t(aV)), (_t(lU), _t(lV)), *fl, n, False,
                        channels=chans).numpy()
    assert got.shape == (4, 2, len(chans), n, n)
    for p, (a, lf) in enumerate(((aU, lU), (aV, lV))):
        one = ti.intra_pred(_t(a), _t(lf), *fl, n, False,
                            channels=chans).numpy()
        assert np.array_equal(got[:, p], one), p


def _race_case(rng, B, n, flat):
    above, left, ha, hl = _edges(rng, B, n, flat)
    src = rng.integers(0, 256, (B, n, n)).astype(np.int32)
    if flat:  # a flat source too: every delta's SAD ties
        src[:] = above[:, :1, None]
    allow = rng.random(B) < 0.5
    allow[:2] = (True, False)
    return above, left, ha, hl, src, allow


@pytest.mark.parametrize("n,flat", [(4, False), (8, False), (16, False),
                                    (32, False), (8, True), (16, True)])
def test_race_matches_jax_pass(n, flat):
    """The race mode's stack and picks equal the JAX pass's on a mix of
    lanes with and without zone 1 allowed; on flat edges and sources
    every SAD ties and the first least (or, with zone 1 barred, the first
    delta) is taken."""
    rng = np.random.default_rng(SEED + 30 + n + 100 * flat)
    above, left, ha, hl, src, allow = _race_case(rng, 6, n, flat)
    stack, di8 = ti.intra_pred(_t(above), _t(left), _t(ha), _t(hl), n, True,
                               src=_t(src), allow_z1=_t(allow))
    jstack, jdi8 = (np.asarray(v) for v in
                    _jax_race(above, left, ha, hl, src, allow))
    assert stack.shape == (6, 13, n, n) and di8.shape == (6, 8)
    assert stack.dtype == di8.dtype == torch.int32
    assert np.array_equal(stack.numpy(), jstack)
    assert np.array_equal(di8.numpy(), jdi8)
    if flat:
        assert (di8.numpy()[allow] == 0).all()


def test_race_reads_a_strided_source():
    """The source is a view of the superblock tile (lane stride 4096, row
    stride 64, an offset), as the pass passes it: the same picks as from
    a contiguous copy."""
    rng = np.random.default_rng(SEED + 40)
    n = 16
    above, left, ha, hl = _edges(rng, 5, n)
    tile = _t(rng.integers(0, 256, (5, 64, 64)).astype(np.int32))
    view = tile[:, 16 : 16 + n, 32 : 32 + n]
    allow = _t(rng.random(5) < 0.5)
    a = (_t(above), _t(left), _t(ha), _t(hl), n, True)
    got = ti.intra_pred(*a, src=view, allow_z1=allow)
    ref = ti.intra_pred(*a, src=view.contiguous(), allow_z1=allow)
    jref = _jax_race(above, left, ha, hl, view.numpy(), allow.numpy())
    for g, r, j in zip(got, ref, jref):
        assert torch.equal(g, r)
        assert np.array_equal(g.numpy(), np.asarray(j))
