"""The wavefront's CFL arm in the port (ops/intra.py cfl_plain, K11's fit,
and cfl_decide_plain, its decision) against the JAX package's, on the
CPU.

The JAX arm is inside the jitted pass (rav1e_tpu/models/wavefront.py:
709-762), so it is composed here from the package's own leaf functions,
run eagerly: cfl_ac_420_batch, the alpha fit, cfl_predict_batch,
fdct_batch, quantize, dequantize, inv_txfm, the pixel SSE and coeff_rate
of the arm, then its symbol rates, use_cfl and selection written out in
jnp as the arm writes them.  The DC outcome the arm competes against is
the JAX chroma_dc's (:581-594) on the same blocks, and both sides take
it as input.  The port runs K11's fit wrapper (cfl_plain on the CPU),
K2's wrapper (its plain version, given the JAX fdct, as the port's
encode tests do) and K3's, then K11's decide wrapper (cfl_decide_plain
on the CPU), also on the strided views the pass gives them.

Tolerances: alphas, predictions, residuals, levels, inverses, the uv mode
and every selected output identical.  The coefficient rate is an fp32
sum of logarithms, summed in another order by each framework: the port's
is held to the JAX rate to 1e-6 relative, and the decision is taken
given the JAX rates on both sides, so that it is compared exactly.  The
CFL SSE is an exact integer sum in the port (f32 in JAX): identical
below 2^24, which every block here is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.ops import intra_jax as ij
from rav1e_tpu.ops import quantize_np as jqz
from rav1e_tpu.ops import transforms_jax as tj
from rav1e_tpu.ops import transforms_np as jtn
from rav1e_tpu_torch.ops import intra as ti
from rav1e_tpu_torch.ops import transforms as tt

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

SEED = 20261018
RATE_NZ, RATE_MAG = 1.45, 0.95  # rav1e_tpu/models/wavefront.py:58-59


def _jax_fdct(resid, Fv, FhT):
    """The JAX package's fdct_batch, as a drop-in for tt.fdct_plain."""
    return torch.from_numpy(np.array(tj.fdct_batch(
        jnp.asarray(resid.numpy()), jnp.asarray(Fv.numpy()),
        jnp.asarray(FhT.numpy()))))


def _coeff_rate(lv):
    a = jnp.abs(lv).astype(jnp.float32)
    nz = (a > 0).sum((-1, -2)).astype(jnp.float32)
    return RATE_NZ * nz + RATE_MAG * jnp.log2(1.0 + a).sum((-1, -2))


def _tabs(rng):
    return (rng.uniform(0.5, 8, (13, 14)).astype(np.float32),
            rng.uniform(0.5, 6, 8).astype(np.float32),
            rng.uniform(0.5, 9, (6, 16)).astype(np.float32))


def _case(rng, n, kind="random"):
    """(luma (B, n, n), dc (B, 2, n2, n2), src, lam, qdc, qac, mode, tabs).
    kind: "random" content, "flat" luma, "clip" (alphas past +-16),
    "one_plane" (U uncorrelated: alpha 0, V not), "signs" (every nonzero
    (sign U, sign V) pair), "tie" (the CFL prediction equals DC, and the
    rate tables make CFL cost exactly DC's)."""
    n2 = n // 2
    dcv = rng.integers(40, 216, (8, 2))
    yy, xx = np.mgrid[0:n2, 0:n2]
    B = 8
    if kind == "random":
        # noisy luma; each plane's residual partly follows its 2x2 means
        luma = np.clip(rng.integers(60, 190, (B, 1, 1))
                       + rng.integers(-60, 61, (B, n, n)), 0, 255)
        lds = luma.reshape(B, n2, 2, n2, 2).mean((2, 4))
        kr = rng.uniform(-1.5, 1.5, (B, 2))
        src = (dcv[:B, :, None, None] + np.round(
            kr[:, :, None, None] * (lds - lds.mean((1, 2), keepdims=True))
            [:, None]).astype(np.int64)
               + rng.integers(-12, 13, (B, 2, n2, n2)))
    else:
        # luma ramps whose 2x2 sums carry the chroma residual's sign
        g = rng.integers(-3, 4, (B, n2, n2))
        base = rng.integers(60, 190, (B, 1, 1))
        luma = np.repeat(np.repeat(base + 6 * g, 2, 1), 2, 2) \
            + rng.integers(0, 2, (B, n, n))
        k = np.ones((B, 2))
        if kind == "flat":
            luma = np.repeat(np.repeat(base, n, 1), n, 2)
        elif kind == "clip":
            k = np.where(np.arange(B)[:, None] % 2, 30.0, -30.0) * np.ones(
                (1, 2))
        elif kind == "one_plane":
            k[:, 0] = 0
        elif kind == "signs":
            pairs = [(su, sv) for su in (-1, 0, 1) for sv in (-1, 0, 1)
                     if (su, sv) != (0, 0)]
            k = np.array(pairs, np.float64) * rng.integers(1, 4, (B, 1))
        elif kind == "tie":
            # 2x2 sums 4a or 4a + 1 in a checkerboard: ac = +-1, so every
            # alpha scales to 0 and the CFL prediction is DC's
            a = rng.integers(30, 60, (B, 1, 1))
            chk = (yy + xx) % 2
            luma = np.zeros((B, n, n), np.int64)
            luma[:, 0::2, 0::2] = a + chk
            luma[:, 0::2, 1::2] = a
            luma[:, 1::2, 0::2] = a
            luma[:, 1::2, 1::2] = a
            g = 2 * chk[None] - 1 + 0 * a
            k = np.full((B, 2), 3.0)
        src = dcv[:B, :, None, None] + np.round(
            k[:, :, None, None] * g[:, None]).astype(np.int64)
    src = np.clip(src, 0, 255)
    dc = np.broadcast_to(dcv[:B, :, None, None], (B, 2, n2, n2))
    lam = rng.uniform(*((20, 3000) if kind == "random" else (2, 10)),
                      B).astype(np.float32)
    qi = rng.integers(30, 200, B)
    qdc = np.asarray([jqz.dc_q(int(q)) for q in qi], np.int32)
    qac = np.asarray([jqz.ac_q(int(q)) for q in qi], np.int32)
    mode = rng.integers(0, 13, B)
    tabs = _tabs(rng)
    if kind == "tie":
        # uv mode CFL + sign + 2 alphas = DC's rate exactly
        tabs[0][:, 0], tabs[0][:, 13] = 3.0, 1.0
        tabs[1][:], tabs[2][:] = 1.0, 0.5
    return (luma.astype(np.int32), np.ascontiguousarray(dc, np.int32),
            src.astype(np.int32), lam, qdc, qac, mode, tabs)


def _jax_dc(dc, src, n2, lam, qdc, qac):
    """chroma_dc of the JAX pass on both planes: levels, inverse, pixel
    SSE and coefficient rate, (B, 2, ...)."""
    Fv, FhT = (jnp.asarray(m) for m in tt.fwd_mats(jtn.DCT_DCT, n2, n2))
    q = lambda v: jnp.asarray(v)[:, None]
    res = jnp.asarray(src - dc)
    lv = tj.quantize(tj.fdct_batch(res, Fv, FhT), q(qdc), q(qac), 0)
    inv = tj.inv_txfm(tj.dequantize(lv, q(qdc), q(qac), 0, 8), jtn.DCT_DCT,
                      8)
    dist = ((res - inv).astype(jnp.float32) ** 2).sum((-1, -2))
    return lv, inv, dist, _coeff_rate(lv)


def _jax_arm(luma, dc, src, lam, qdc, qac, mode, tabs, dc_out):
    """The JAX arm (wavefront.py:709-762) on both planes: returns the
    chosen (pred, levels, inverse) (B, 2, ...), the rates (B, 2), the
    alphas kept, the uv mode, and the CFL side's alphas, prediction,
    residual, levels and rates before the choice."""
    n2 = dc.shape[-1]
    Fv, FhT = (jnp.asarray(m) for m in tt.fwd_mats(jtn.DCT_DCT, n2, n2))
    lv_dc, inv_dc, dist_dc, rate_dc = dc_out
    lam = jnp.asarray(lam)
    cost_dc = dist_dc + lam[:, None] * rate_dc
    ac = ij.cfl_ac_420_batch(jnp.asarray(luma))
    a_den = (ac.astype(jnp.float32) ** 2).sum((-1, -2))
    side = []
    for p in (0, 1):
        res = jnp.asarray(src[:, p] - dc[:, p])
        num = (res.astype(jnp.float32) * ac).sum((-1, -2))
        af = jnp.round(64.0 * num / jnp.maximum(a_den, 1.0))
        a = jnp.where(a_den > 0, jnp.clip(af, -16, 16), 0.0).astype(
            jnp.int32)
        pc = ij.cfl_predict_batch(jnp.asarray(dc[:, p]), ac, a, 8)
        rc = jnp.asarray(src[:, p]) - pc
        lc = tj.quantize(tj.fdct_batch(rc, Fv, FhT), qdc, qac, 0)
        invc = tj.inv_txfm(tj.dequantize(lc, qdc, qac, 0, 8), jtn.DCT_DCT,
                           8)
        dist = ((rc - invc).astype(jnp.float32) ** 2).sum((-1, -2))
        ratec = _coeff_rate(lc)
        side.append((a, pc, rc, lc, invc, ratec, dist + lam * ratec))
    (a_u, pu, ru, lu, iu, rtu, cu), (a_v, pv, rv, lv, iv, rtv, cv) = side
    cost_u = jnp.where(a_u == 0, cost_dc[:, 0], cu)
    cost_v = jnp.where(a_v == 0, cost_dc[:, 1], cv)
    bits_uv14, bits_sign, bits_alpha = (jnp.asarray(t) for t in tabs)
    su = jnp.where(a_u == 0, 0, jnp.where(a_u < 0, 1, 2))
    sv = jnp.where(a_v == 0, 0, jnp.where(a_v < 0, 1, 2))
    rate_dc_uv = bits_uv14[mode, 0]
    rate_cfl = bits_uv14[mode, 13] + bits_sign[su * 3 + sv - 1]
    rate_cfl = rate_cfl + jnp.where(
        su > 0, bits_alpha[jnp.where(su == 2, 3, 0) + sv, jnp.abs(a_u) - 1],
        0.0)
    rate_cfl = rate_cfl + jnp.where(
        sv > 0, bits_alpha[jnp.where(sv == 2, 3, 0) + su, jnp.abs(a_v) - 1],
        0.0)
    use_cfl = ((a_u != 0) | (a_v != 0)) & (
        cost_u + cost_v + lam * rate_cfl
        < cost_dc[:, 0] + cost_dc[:, 1] + lam * rate_dc_uv)
    take = jnp.stack([use_cfl & (a_u != 0), use_cfl & (a_v != 0)], 1)
    t4 = take[:, :, None, None]
    st = lambda u, v: jnp.stack([u, v], 1)
    out = (jnp.where(t4, st(pu, pv), jnp.asarray(dc)),
           jnp.where(t4, st(lu, lv), lv_dc),
           jnp.where(t4, st(iu, iv), inv_dc),
           jnp.where(take, st(rtu, rtv), rate_dc),
           jnp.where(take, st(a_u, a_v), 0),
           jnp.where(use_cfl, 13, 0))
    return out, (st(a_u, a_v), st(pu, pv), st(ru, rv), st(lu, lv),
                 st(rtu, rtv))


def _view(x, C=7):
    """x (B, 2, ...) as channel 0 of a (B, 2, C, ...) stack: the strided
    view through which chroma passes K1's DC prediction, K2's levels and
    rates, K3's inverse and the SSE to the arm."""
    stack = torch.zeros(x.shape[:2] + (C,) + x.shape[2:], dtype=x.dtype)
    stack[:, :, 0] = x
    return stack[:, :, 0]


def _port_arm(luma, dc, src, lam, qdc, qac, mode, tabs, dc_out, jrate,
              monkeypatch, views=False):
    """The port's arm: K11's fit (ti.cfl: cfl_plain on the CPU), K2 given
    the JAX fdct, K3, then cfl_decide_plain given the JAX rates (jrate:
    the CFL side's).  With views, the fit and the decision read their
    inputs through strided views, as the pass gives them: the luma rows
    of a wider buffer, the sources plane-major, the DC side as channel 0
    of candidate stacks."""
    n2 = dc.shape[-1]
    T = torch.from_numpy
    Fv, FhT = (T(m)[None] for m in tt.fwd_mats(jtn.DCT_DCT, n2, n2))
    y, d, s = T(luma), T(dc), T(src)
    if views:
        buf = torch.zeros(y.shape[:2] + (y.shape[2] + 8,), dtype=y.dtype)
        buf[:, :, : y.shape[2]] = y
        y, d = buf[:, :, : y.shape[2]], _view(d)
        s = s.transpose(0, 1).contiguous().transpose(0, 1)
        assert not (y.is_contiguous() or d.is_contiguous()
                    or s.is_contiguous())
    alpha, pc, rc = ti.cfl(y, d, s)
    q2 = lambda v: T(v)[:, None].expand(len(v), 2)
    with monkeypatch.context() as mp:
        mp.setattr(tt, "fdct_plain", _jax_fdct)
        lc, dqc, _t, ratec = tt.fwd_txq(rc, Fv, FhT, q2(qdc), q2(qac), 0)
    ic = tt.inv_txfm(dqc, jtn.DCT_DCT, 8)
    lv_dc, inv_dc, dist_dc, rate_dc = (T(np.array(v)) for v in dc_out)
    if views:
        lv_dc, inv_dc, dist_dc, rate_dc = map(
            _view, (lv_dc, inv_dc, dist_dc, rate_dc))
    out = ti.cfl_decide(
        rc, ic, lc, T(np.array(jrate)), alpha, pc, d, lv_dc, inv_dc,
        dist_dc, rate_dc, T(lam), T(mode.astype(np.int64)),
        tuple(T(t) for t in tabs))
    return out, (alpha, pc, rc, lc, ratec)


def _run(n, kind, monkeypatch, views=False):
    rng = np.random.default_rng([SEED, n, len(kind)])
    luma, dc, src, lam, qdc, qac, mode, tabs = _case(rng, n, kind)
    dc_out = _jax_dc(dc, src, n // 2, lam, qdc, qac)
    jout, jside = _jax_arm(luma, dc, src, lam, qdc, qac, mode, tabs, dc_out)
    pout, pside = _port_arm(luma, dc, src, lam, qdc, qac, mode, tabs, dc_out,
                            jside[4], monkeypatch, views)
    for name, j, p in zip(("alpha", "pred", "resid", "levels"), jside[:4],
                          pside[:4]):
        np.testing.assert_array_equal(p.numpy(), np.array(j), err_msg=name)
    np.testing.assert_allclose(pside[4].numpy(), np.array(jside[4]),
                               rtol=1e-6)
    for name, j, p in zip(("pred", "levels", "inverse", "rate", "alpha",
                           "uv_mode"), jout, pout):
        np.testing.assert_array_equal(p.numpy(), np.array(j), err_msg=name)
    return jside[0], pout


@pytest.mark.parametrize("n", [8, 16, 32])
def test_cfl_arm_matches_jax(n, monkeypatch):
    alpha, out = _run(n, "random", monkeypatch)
    assert np.array(alpha).any()


def test_flat_luma_keeps_dc(monkeypatch):
    alpha, out = _run(16, "flat", monkeypatch)
    assert not np.array(alpha).any()
    assert not out[5].any() and not out[4].any()


def test_alphas_clip_at_16(monkeypatch):
    alpha, _ = _run(16, "clip", monkeypatch)
    a = np.array(alpha)
    assert (a == 16).any() and (a == -16).any()


def test_one_plane_at_alpha_zero(monkeypatch):
    alpha, out = _run(8, "one_plane", monkeypatch)
    a = np.array(alpha)
    assert (a[:, 0] == 0).all() and (a[:, 1] != 0).all()
    # where CFL won, U keeps DC (alpha 0) and V takes CFL
    won = out[5].numpy() == 13
    assert won.any() and not out[4][won, 0].any()


def test_every_sign_pair(monkeypatch):
    alpha, out = _run(16, "signs", monkeypatch)
    a = np.sign(np.array(alpha))
    pairs = {(int(u), int(v)) for u, v in a}
    assert pairs == {(u, v) for u in (-1, 0, 1) for v in (-1, 0, 1)} - {
        (0, 0)}


@pytest.mark.parametrize("nudge", [0.0, 2.0 ** -10])
def test_cost_tie_keeps_dc(nudge, monkeypatch):
    """CFL's cost equal to DC's keeps DC (use_cfl's strict <); DC's rate
    one step dearer takes CFL."""
    rng = np.random.default_rng([SEED, 16, 3])
    luma, dc, src, lam, qdc, qac, mode, tabs = _case(rng, 16, "tie")
    tabs[0][:, 0] += nudge
    dc_out = _jax_dc(dc, src, 8, lam, qdc, qac)
    jout, jside = _jax_arm(luma, dc, src, lam, qdc, qac, mode, tabs, dc_out)
    pout, pside = _port_arm(luma, dc, src, lam, qdc, qac, mode, tabs, dc_out,
                            jside[4], monkeypatch)
    # the CFL prediction is DC's, with both alphas nonzero
    np.testing.assert_array_equal(pside[1].numpy(), dc)
    assert (pside[0].numpy() != 0).all()
    for j, p in zip(jout, pout):
        np.testing.assert_array_equal(p.numpy(), np.array(j))
    assert (pout[5].numpy() == (13 if nudge else 0)).all()


@pytest.mark.parametrize("n", [8, 32])
def test_arm_reads_strided_views(n, monkeypatch):
    """The arm given its inputs as the pass's strided views (K1's DC
    prediction as channel 0 of its stack, and so on) equals the JAX arm
    on the same blocks."""
    alpha, _ = _run(n, "random", monkeypatch, views=True)
    assert np.array(alpha).any()
