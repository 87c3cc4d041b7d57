"""K2 (fwd_txq) at every call shape the port's passes make, against the
JAX chain, on the CPU.

The wrapper reads broadcast views in place on the card (block_layout): a
lane's quantisers over its candidates, one residual over five tx types,
arange(T) keys over the lanes.  Each case below builds its inputs the way
its call site does (models/wavefront.py, models/device_pipeline.py), from
one seed with numpy, runs them through the wrapper (on the CPU its plain
version) and through the JAX package's fdct_batch, quantize and
dequantize (transforms_jax), with the RD sums and, for the inter race,
the level-1 thinning written as the JAX pass writes them.

Tie rule: the forward transform is an fp32 product rounded half to even,
summed in another order by each framework, so a coefficient within an
ulp of .5 may round the other way.  Given the JAX fdct (the drop-in the
whole-encode tests use), levels and dequantised values must be identical
and the sums agree to rtol 1e-5.  With the port's own fdct, coefficients
may differ by at most 1 and only where the exact (float64) value lies
within the fp32 error of a .5 tie (chip_smoke.py's fdct_ties), levels and
dequantised values must be identical wherever the integer coefficients
agree, and the sums agree to rtol 1e-5 on blocks without such a
coefficient.  (The share cap of tests/test_torch_ops.py, FDCT_TIE_SHARE
of the coefficients, does not fit DCT_DCT blocks of n >= 16 whatever
the data: the basis products at positions such as (n/2, 0) are rational,
so about 1% of an integer residual's coefficients are exact .5 ties,
which each framework's fp32 error moves either way.)  The float-floor
variant's sums agree to rtol 1e-5 and its nnz exactly, except on at most
FDCT_TIE_SHARE of the blocks (and at least one).

The layout test emulates the kernel's index map ((b // div) % mod) *
stride on the views' storage, so it checks in pure Python what the card
reads.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.ops import quantize_np as jqz
from rav1e_tpu.ops import transforms_jax as tj
from rav1e_tpu.ops import transforms_np as jtn
from rav1e_tpu_torch.ops import transforms as tt

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

SEED = 20261018
FDCT_TIE_SHARE = 1e-3
_TYPES5 = (jtn.DCT_DCT, jtn.ADST_ADST, jtn.ADST_DCT, jtn.DCT_ADST, jtn.IDTX)
# the uv race's 7 candidates index these 5 tx types (wavefront UV_CANDS)
_UV_KEYS = (0, 0, 0, 0, 0, 1, 4)


def _mats(types, n):
    m = min(n, 32)  # TX_64X64 codes its top-left 32x32
    mats = [tt.fwd_mats(t, n, n) for t in types]
    return (np.stack([a[:m, :] for a, _ in mats]),
            np.stack([b[:, :m] for _, b in mats]))


def _resid(rng, shape, n):
    """Residuals with structure (ramps) and noise, like mode-race inputs."""
    yy, xx = np.mgrid[0:n, 0:n]
    slope = rng.integers(-6, 7, shape + (2, 1, 1))
    base = (slope[..., 0, :, :] * yy + slope[..., 1, :, :] * xx
            + rng.integers(-60, 60, shape + (1, 1)))
    noise = rng.integers(-20, 21, shape + (n, n))
    return np.clip(base + noise, -255, 255).astype(np.int32)


def _quant(rng, B):
    qi = rng.integers(40, 220, B)
    return (np.asarray([jqz.dc_q(int(q)) for q in qi], np.int32),
            np.asarray([jqz.ac_q(int(q)) for q in qi], np.int32))


@partial(jax.jit, static_argnums=(5, 6))
def _jax_chain(resid, Fv, FhT, qdc, qac, shift, thin, thr):
    """fdct_batch, quantize, (the inter race's level-1 thinning,
    models/wavefront.py:441-446), dequantize, the tx-domain SSE and
    coeff_rate over (nb, n, n) blocks of one tx type."""
    cf = tj.fdct_batch(resid, Fv, FhT)
    lv = tj.quantize(cf, qdc, qac, shift)
    if thin:
        mag = jnp.abs(cf) << shift
        drop = (jnp.abs(lv) == 1) & (mag.astype(jnp.float32)
                                     < thr[:, None, None])
        drop = drop.at[:, 0, 0].set(False)
        lv = jnp.where(drop, 0, lv)
    dq = tj.dequantize(lv, qdc, qac, shift, 8)
    qerr = ((cf - dq) << shift).astype(jnp.float32)
    a = jnp.abs(lv).astype(jnp.float32)
    rate = (tt.RATE_NZ * (a > 0).sum((-1, -2)).astype(jnp.float32)
            + tt.RATE_MAG * jnp.log2(1.0 + a).sum((-1, -2)))
    return cf, lv, dq, (qerr * qerr).sum((-1, -2)), rate


def _jax_ref(resid, Fv, FhT, tidx, qdc, qac, shift, thr):
    """The JAX chain on flattened blocks, one call per tx type."""
    nb = tidx.size
    n, m = resid.shape[-1], Fv.shape[-2]
    flat = lambda v: np.ascontiguousarray(v).reshape(nb, *v.shape[
        tidx.ndim:])
    x, ti, qd, qa = flat(resid), tidx.reshape(-1), flat(qdc), flat(qac)
    th = flat(thr) if thr is not None else np.zeros(nb, np.float32)
    out = [np.zeros((nb, m, m), np.int32) for _ in range(3)] + [
        np.zeros(nb, np.float32) for _ in range(2)]
    for t in np.unique(ti):
        sel = np.nonzero(ti == t)[0]
        got = _jax_chain(jnp.asarray(x[sel]), jnp.asarray(Fv[t]),
                         jnp.asarray(FhT[t]), jnp.asarray(qd[sel]),
                         jnp.asarray(qa[sel]), shift, thr is not None,
                         jnp.asarray(th[sel]))
        for o, g in zip(out, got):
            o[sel] = np.asarray(g)
    return [o.reshape(tidx.shape + o.shape[1:]) for o in out]


def _case(name, rng):
    """(torch arguments, keywords, numpy reference arguments) of one call
    shape, built as its call site builds it."""
    B = 4
    if name.startswith("race13"):  # wavefront.py:527, the mode race
        n = int(name[-2:])
        Fv, FhT = _mats((jtn.DCT_DCT,), n)
        r = _resid(rng, (B, 13), n)
        qdc, qac = _quant(rng, B)
        q = lambda v: torch.from_numpy(v)[:, None].expand(B, 13)
        return ((torch.from_numpy(r), torch.from_numpy(Fv),
                 torch.from_numpy(FhT), q(qdc), q(qac),
                 jqz.tx_scale(n, n)), {},
                (r, Fv, FhT, np.zeros((B, 13), np.int32),
                 np.repeat(qdc[:, None], 13, 1),
                 np.repeat(qac[:, None], 13, 1), None))
    if name.startswith("types5"):  # wavefront.py:542-547, tx-type race
        n = int(name[-2:])
        Fv, FhT = _mats(_TYPES5, n)
        r = _resid(rng, (B,), n)
        qdc, qac = _quant(rng, B)
        q = lambda v: torch.from_numpy(v)[:, None].expand(B, 5)
        keys = torch.arange(5, dtype=torch.int32).expand(B, 5)
        return ((torch.from_numpy(r)[:, None].expand(B, 5, n, n),
                 torch.from_numpy(Fv), torch.from_numpy(FhT), q(qdc),
                 q(qac), jqz.tx_scale(n, n)), {"tidx": keys},
                (np.repeat(r[:, None], 5, 1), Fv, FhT, keys.numpy(),
                 np.repeat(qdc[:, None], 5, 1),
                 np.repeat(qac[:, None], 5, 1), None))
    if name.startswith("uv2x7"):  # wavefront.py:403-412, the uv race
        n = int(name[-2:])
        Fv, FhT = _mats(_TYPES5, n)
        r = _resid(rng, (B, 2, 7), n)
        qdc, qac = _quant(rng, B)
        q = lambda v: torch.from_numpy(v)[:, None, None].expand(B, 2, 7)
        keys = torch.as_tensor(_UV_KEYS, dtype=torch.int32)[:7].expand(
            B, 2, 7)
        rep = lambda v: np.broadcast_to(v[:, None, None], (B, 2, 7))
        return ((torch.from_numpy(r), torch.from_numpy(Fv),
                 torch.from_numpy(FhT), q(qdc), q(qac), 0), {"tidx": keys},
                (r, Fv, FhT, keys.numpy(), rep(qdc), rep(qac), None))
    if name == "race7_n64":  # wavefront.py:624-628, the 64x64 trial
        Fv, FhT = _mats((jtn.DCT_DCT,), 64)
        r = _resid(rng, (2, 7), 64)
        qdc, qac = _quant(rng, 2)
        q = lambda v: torch.from_numpy(v)[:, None].expand(2, 7)
        return ((torch.from_numpy(r), torch.from_numpy(Fv),
                 torch.from_numpy(FhT), q(qdc), q(qac), 2), {},
                (r, Fv, FhT, np.zeros((2, 7), np.int32),
                 np.repeat(qdc[:, None], 7, 1),
                 np.repeat(qac[:, None], 7, 1), None))
    if name == "cfl2_n16":  # wavefront.py:462-465, CFL's two planes
        Fv, FhT = _mats((jtn.DCT_DCT,), 16)
        r = _resid(rng, (B, 2), 16)
        qdc, qac = _quant(rng, B)
        q = lambda v: torch.from_numpy(v)[:, None].expand(B, 2)
        return ((torch.from_numpy(r), torch.from_numpy(Fv),
                 torch.from_numpy(FhT), q(qdc), q(qac), 0), {},
                (r, Fv, FhT, np.zeros((B, 2), np.int32),
                 np.repeat(qdc[:, None], 2, 1),
                 np.repeat(qac[:, None], 2, 1), None))
    if name.startswith("thin"):  # wavefront.py:796-801, the inter race
        n, C = int(name[-2:]), 6
        Fv, FhT = _mats((jtn.DCT_DCT,), n)
        r = _resid(rng, (B, C), n)
        qdc, qac = _quant(rng, B)
        thr = ((rng.random(B) * 400 + qac) / 2.0).astype(np.float32)
        ex = lambda v: torch.from_numpy(v)[:, None].expand(B, C)
        rep = lambda v: np.repeat(v[:, None], C, 1)
        return ((torch.from_numpy(r), torch.from_numpy(Fv),
                 torch.from_numpy(FhT), ex(qdc), ex(qac),
                 jqz.tx_scale(n, n)), {"thr": ex(thr)},
                (r, Fv, FhT, np.zeros((B, C), np.int32), rep(qdc),
                 rep(qac), rep(thr)))
    raise KeyError(name)


SHAPES = ("race13_n16", "race13_n32", "types5_n08", "types5_n16",
          "uv2x7_n04", "uv2x7_n08", "race7_n64", "cfl2_n16", "thin_n16",
          "thin_n32")


def _jax_fdct(resid, Fv, FhT):
    """The JAX package's fdct_batch, as a drop-in for tt.fdct_plain."""
    return torch.from_numpy(np.array(_fdct_jit(
        jnp.asarray(resid.numpy()), jnp.asarray(Fv.numpy()),
        jnp.asarray(FhT.numpy()))))


_fdct_jit = jax.jit(tj.fdct_batch)


def _ties(resid, Fv, FhT, tidx):
    """Coefficients whose exact (float64) value lies within 8x the fp32
    error of the plain product (at least 2^-22 relative) of a .5 tie:
    there another fp32 summation order may round the other way (the rule
    of chip_smoke.py's fdct_ties)."""
    x = resid.astype(np.float64)
    y64 = Fv[tidx].astype(np.float64) @ x @ FhT[tidx].astype(np.float64)
    y32 = (torch.from_numpy(Fv[tidx]) @ (torch.from_numpy(resid).float()
           @ torch.from_numpy(FhT[tidx]))).double().numpy()
    err = np.maximum(np.abs(y32 - y64), np.abs(y64) * 2.0 ** -22)
    frac = np.abs(y64) - np.floor(np.abs(y64))
    return np.abs(frac - 0.5) <= 8 * err


@pytest.mark.parametrize("name", SHAPES)
def test_call_shape_matches_jax(name, monkeypatch):
    """Given the JAX fdct, levels and dequantised values identical and the
    sums to fp32 order; with the port's own fdct, every coefficient that
    rounds otherwise than JAX's is an fp32 tie, and off those the levels
    are identical."""
    rng = np.random.default_rng(SEED + SHAPES.index(name))
    a, k, ref = _case(name, rng)
    resid, Fv, FhT, tidx, qdc, qac, thr = ref
    shift = a[5]
    m = Fv.shape[-2]
    cf_j, lv_j, dq_j, dist_j, rate_j = _jax_ref(resid, Fv, FhT, tidx, qdc,
                                                qac, shift, thr)
    with monkeypatch.context() as mp:
        mp.setattr(tt, "fdct_plain", _jax_fdct)
        lv, dq, dist, rate = (v.numpy() for v in tt.fwd_txq(*a, **k))
    assert lv.shape == dq.shape == tidx.shape + (m, m)
    assert np.array_equal(lv, lv_j) and np.array_equal(dq, dq_j)
    np.testing.assert_allclose(dist, dist_j, rtol=1e-5)
    np.testing.assert_allclose(rate, rate_j, rtol=1e-5)

    lv, dq, dist, rate = (v.numpy() for v in tt.fwd_txq(*a, **k))
    cf = tt.fdct_plain(torch.from_numpy(resid), torch.from_numpy(Fv[tidx]),
                       torch.from_numpy(FhT[tidx])).numpy()
    moved = cf != cf_j
    assert np.abs(cf - cf_j).max() <= 1
    assert not (moved & ~_ties(resid, Fv, FhT, tidx)).any()
    assert np.array_equal(lv[~moved], lv_j[~moved])
    assert np.array_equal(dq[~moved], dq_j[~moved])
    clean = ~moved.any(axis=(-1, -2))
    np.testing.assert_allclose(dist[clean], dist_j[clean], rtol=1e-5)
    np.testing.assert_allclose(rate[clean], rate_j[clean], rtol=1e-5)
    if thr is not None:  # the thinning dropped levels here
        unthinned = tt.fwd_txq(*a)[0].numpy()
        assert (np.abs(unthinned) == 1).sum() > (np.abs(lv) == 1).sum()


@pytest.mark.parametrize("name", ["race13_n16", "thin_n32"])
def test_sums_only_equals_full(name):
    """levels=False (the 13-candidate race's call): no levels, and the
    same dist and rate as the full call."""
    a, k, _ref = _case(name, np.random.default_rng(SEED))
    full = tt.fwd_txq(*a, **k)
    lv, dq, dist, rate = tt.fwd_txq(*a, levels=False, **k)
    assert lv is None and dq is None
    assert torch.equal(dist, full[2]) and torch.equal(rate, full[3])


@jax.jit
def _jax_float_rd(resid, Fv, FhT, qm):
    """models/device_pipeline.py:167-181's float RD on (nb, n, n) blocks
    (unscaled distortion, rate, nnz), qm the (n, n) grid q / 2^shift."""
    y = jnp.einsum("ij,bjk,kl->bil", Fv, resid.astype(jnp.float32), FhT)
    mag = jnp.abs(y)
    level = jnp.floor((mag + qm * (13.0 / 32.0)) / qm)
    err = (mag - level * qm) * (2.0 if resid.shape[-1] == 32 else 1.0)
    nnz = (level > 0).sum((-1, -2))
    rate = (tt.RATE_NZ * nnz
            + tt.RATE_MAG * jnp.log2(1.0 + level).sum((-1, -2)))
    return (err * err).sum((-1, -2)), rate, nnz


@pytest.mark.parametrize("n", [16, 32])
def test_float_variant_matches_jax(n):
    """fwd_rd_float (frame_rd_maps and the band maps: 10 candidates over
    a plane's blocks, scalar quantisers) against the JAX float RD."""
    rng = np.random.default_rng(SEED + 100 + n)
    r = _resid(rng, (10, 3, 2), n)
    Fv, FhT = (v[0] for v in _mats((jtn.DCT_DCT,), n))
    shift = 1 if n == 32 else 0
    dc_q, ac_q = jqz.dc_q(100), jqz.ac_q(100)
    dist, rate, nnz = (v.numpy() for v in tt.fwd_rd_float(
        torch.from_numpy(r), torch.from_numpy(Fv), torch.from_numpy(FhT),
        dc_q, ac_q, shift))
    qm = np.full((n, n), ac_q, np.float32)
    qm[0, 0] = dc_q
    qm /= 1 << shift
    dj, rj, zj = (np.asarray(v).reshape(dist.shape) for v in _jax_float_rd(
        jnp.asarray(r.reshape(-1, n, n)), jnp.asarray(Fv), jnp.asarray(FhT),
        jnp.asarray(qm)))
    same = nnz == zj
    assert 1 - same.mean() <= FDCT_TIE_SHARE + 1.0 / same.size
    np.testing.assert_allclose(dist[same], dj[same], rtol=1e-5)
    np.testing.assert_allclose(rate[same], rj[same], rtol=1e-5)


def _read_as_kernel(v, batch, inner=0):
    """What the kernel reads for each block under block_layout: element
    ((b // div) % mod) * stride (+ the n x n tile) of v's storage."""
    div, mod, stride = tt.block_layout(v, batch, inner)
    nb = int(np.prod(batch))
    base = torch.as_strided(v, (v.untyped_storage().nbytes()
                                // v.element_size() - v.storage_offset(),),
                            (1,), v.storage_offset())
    off = ((torch.arange(nb) // div) % mod) * stride
    if not inner:
        return base[off].reshape(batch)
    return torch.stack([base[o:o + inner * inner] for o in off.tolist()]
                       ).reshape(tuple(batch) + (inner, inner))


_B = 6
_q = torch.arange(_B, dtype=torch.int32) * 7 + 3
_r = torch.arange(_B * 64, dtype=torch.int32).reshape(_B, 8, 8)
_m = torch.arange(_B * 3, dtype=torch.int32).reshape(_B, 3)
_plane = torch.arange(64 * 64, dtype=torch.int32).reshape(64, 64)
LAYOUTS = {
    # (view, batch, inner, in place?)
    "lane_over_13": (_q[:, None].expand(_B, 13), (_B, 13), 0, True),
    "lane_over_2x7": (_q[:, None, None].expand(_B, 2, 7), (_B, 2, 7), 0,
                      True),
    "keys_arange5": (torch.arange(5, dtype=torch.int32).expand(_B, 5),
                     (_B, 5), 0, True),
    "uv_keys_2x7": (torch.as_tensor(_UV_KEYS, dtype=torch.int32).expand(
        _B, 2, 7), (_B, 2, 7), 0, True),
    "resid_over_5": (_r[:, None].expand(_B, 5, 8, 8), (_B, 5), 8, True),
    "contiguous": (_r.reshape(_B, 1, 8, 8), (_B, 1), 8, True),
    "strided_column": (_m[:, 1], (_B,), 0, True),
    "scalar": (torch.tensor(5, dtype=torch.int32), (_B, 4), 0, True),
    "transposed": (_m.t(), (3, _B), 0, False),
    "plane_tiles": (_plane[None, :16, :16], (1,), 16, False),
    "broadcast_inside": (_m[:, None, :].expand(_B, 2, 3), (_B, 2, 3), 0,
                         False),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_broadcast_layout(name):
    """Which views the wrapper passes to the kernel in place (by their
    period, block_layout) and which it copies; the in-place ones read, by
    the kernel's index map, exactly the broadcast values."""
    v, batch, inner, in_place = LAYOUTS[name]
    lay = tt.block_layout(v, batch, inner)
    assert (lay is not None) == in_place, lay
    if in_place:
        want = v.expand(tuple(batch) + ((inner, inner) if inner else ()))
        assert torch.equal(_read_as_kernel(v, batch, inner), want)
    t, lay2 = tt._per_block(v, batch, v.dtype, v.get_device(), inner)
    assert (t is v) == in_place
    if not in_place:  # the copy: contiguous, read block by block
        assert lay2 == (1, int(np.prod(batch)), max(inner, 1) ** 2)
        assert t.is_contiguous()


def test_launch_refuses_a_cpu_tensor():
    """kernels.launch on a tensor that lies on no CUDA device raises
    ValueError before it loads or counts anything."""
    from rav1e_tpu_torch import kernels

    before = kernels.COUNTS["fwd_txq"]
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kernels.launch("fwd_txq", torch.zeros(1))
    assert kernels.COUNTS["fwd_txq"] == before
