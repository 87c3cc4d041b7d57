"""AV1 transforms in PyTorch: the bit-exact integer inverse transform (K3)
and the fused forward transform + quantiser + RD sums (K2).

Counterpart of rav1e_tpu/ops/transforms_jax.py.  The inverse path is
NORMATIVE (spec 7.13.3) and matches ops/transforms_np.py bit for bit, int32
throughout.  The forward transform is an encoder choice: an fp32 product
`Fv . x . FhT` rounded half to even, so a different summation order can
move a coefficient that lands within an ulp of .5 by one, which perturbs
the quantiser input and never conformance.

Every public function takes tensors on one device.  On a CUDA tensor the
wrapper launches its hand-written kernel (rav1e_tpu_torch/csrc) and raises
if it cannot; on a CPU tensor it runs the plain PyTorch version beside it.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from rav1e_tpu_torch import kernels
from rav1e_tpu_torch.ops import transforms_np as tn
from rav1e_tpu_torch.ops.quantize_np import QUANT_BIAS_NUM

COS_BIT = 12
_C = [int(v) for v in tn.COSPI]
_SINPI = [int(v) for v in tn.SINPI]
SQRT2 = 5793
INV_SQRT2 = 2896
# rate model of the device RD (bits ~ RATE_NZ per significant coefficient
# + RATE_MAG per magnitude octave), shared with the wavefront and band maps
RATE_NZ = 1.45
RATE_MAG = 0.95


def _r2(x, bit):
    return (x + (1 << (bit - 1))) >> bit


def _hb(w0, x0, w1, x1):
    return _r2(w0 * x0 + w1 * x1, COS_BIT)


c = _C


def _stk(xs):
    return torch.stack(xs, dim=-1)


def idct4(x):
    s0, s1, s2, s3 = x[..., 0], x[..., 2], x[..., 1], x[..., 3]
    b0 = _hb(c[32], s0, c[32], s1)
    b1 = _hb(c[32], s0, -c[32], s1)
    b2 = _hb(c[48], s2, -c[16], s3)
    b3 = _hb(c[16], s2, c[48], s3)
    return _stk([b0 + b3, b1 + b2, b1 - b2, b0 - b3])


def idct8(x):
    ev = idct4(x[..., 0::2])
    s4, s5, s6, s7 = x[..., 1], x[..., 5], x[..., 3], x[..., 7]
    b4 = _hb(c[56], s4, -c[8], s7)
    b5 = _hb(c[24], s5, -c[40], s6)
    b6 = _hb(c[40], s5, c[24], s6)
    b7 = _hb(c[8], s4, c[56], s7)
    s4, s5, s6, s7 = b4 + b5, b4 - b5, -b6 + b7, b6 + b7
    b5 = _hb(-c[32], s5, c[32], s6)
    b6 = _hb(c[32], s5, c[32], s6)
    return _stk([ev[..., 0] + s7, ev[..., 1] + b6, ev[..., 2] + b5,
                 ev[..., 3] + s4, ev[..., 3] - s4, ev[..., 2] - b5,
                 ev[..., 1] - b6, ev[..., 0] - s7])


def idct16(x):
    ev = idct8(x[..., 0::2])
    s = [x[..., i] for i in (1, 9, 5, 13, 3, 11, 7, 15)]
    b8 = _hb(c[60], s[0], -c[4], s[7])
    b15 = _hb(c[4], s[0], c[60], s[7])
    b9 = _hb(c[28], s[1], -c[36], s[6])
    b14 = _hb(c[36], s[1], c[28], s[6])
    b10 = _hb(c[44], s[2], -c[20], s[5])
    b13 = _hb(c[20], s[2], c[44], s[5])
    b11 = _hb(c[12], s[3], -c[52], s[4])
    b12 = _hb(c[52], s[3], c[12], s[4])
    s8, s9, s10, s11 = b8 + b9, b8 - b9, -b10 + b11, b10 + b11
    s12, s13, s14, s15 = b12 + b13, b12 - b13, -b14 + b15, b14 + b15
    b9 = _hb(-c[16], s9, c[48], s14)
    b14 = _hb(c[48], s9, c[16], s14)
    b10 = _hb(-c[48], s10, -c[16], s13)
    b13 = _hb(-c[16], s10, c[48], s13)
    b8, b11, b12, b15 = s8, s11, s12, s15
    s8, s9, s10, s11 = b8 + b11, b9 + b10, b9 - b10, b8 - b11
    s12, s13, s14, s15 = -b12 + b15, -b13 + b14, b13 + b14, b12 + b15
    b10 = _hb(-c[32], s10, c[32], s13)
    b13 = _hb(c[32], s10, c[32], s13)
    b11 = _hb(-c[32], s11, c[32], s12)
    b12 = _hb(c[32], s11, c[32], s12)
    odd = [s8, s9, b10, b11, b12, b13, s14, s15]
    return _stk([ev[..., i] + odd[7 - i] for i in range(8)]
                + [ev[..., 7 - i] - odd[i] for i in range(8)])


def _pairs(b, lo, n):
    """Butterfly stage over consecutive pairs starting at lo: even pairs
    (a + b, a - b), odd pairs (-a + b, a + b)."""
    t = list(b)
    for p in range(n):
        i = lo + 2 * p
        if p % 2 == 0:
            t[i], t[i + 1] = b[i] + b[i + 1], b[i] - b[i + 1]
        else:
            t[i], t[i + 1] = -b[i] + b[i + 1], b[i] + b[i + 1]
    return t


def _groups(b, lo, size, count):
    """Butterfly stage over groups of `size`: even groups fold inward with
    (+, -), odd groups with (-, +)."""
    t = list(b)
    for g in range(count):
        base = lo + size * g
        for k in range(size // 2):
            a, z = b[base + k], b[base + size - 1 - k]
            if g % 2 == 0:
                t[base + k], t[base + size - 1 - k] = a + z, a - z
            else:
                t[base + k], t[base + size - 1 - k] = -a + z, a + z
    return t


def _twiddle(cur, pairs):
    nxt = list(cur)
    for (i, j, a, neg) in pairs:
        ti, tj = cur[i], cur[j]
        if not neg:
            nxt[i] = _hb(-c[a], ti, c[64 - a], tj)
            nxt[j] = _hb(c[64 - a], ti, c[a], tj)
        else:
            nxt[i] = _hb(-c[64 - a], ti, -c[a], tj)
            nxt[j] = _hb(-c[a], ti, c[64 - a], tj)
    return nxt


def idct32(x):
    ev = idct16(x[..., 0::2])
    idx = [1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31]
    s = [x[..., i] for i in idx]
    ang = [62, 30, 46, 14, 54, 22, 38, 6]
    b = [None] * 16
    for k in range(8):
        b[k] = _hb(c[ang[k]], s[k], -c[64 - ang[k]], s[15 - k])
        b[15 - k] = _hb(c[64 - ang[k]], s[k], c[ang[k]], s[15 - k])
    t = _pairs(b, 0, 8)
    b = _twiddle(t, [(1, 14, 8, False), (2, 13, 8, True),
                     (5, 10, 40, False), (6, 9, 40, True)])
    t = _groups(b, 0, 4, 4)
    b = _twiddle(t, [(2, 13, 16, False), (3, 12, 16, False),
                     (4, 11, 16, True), (5, 10, 16, True)])
    t = _groups(b, 0, 8, 2)
    b = list(t)
    for k in range(4, 8):
        b[k] = _hb(-c[32], t[k], c[32], t[15 - k])
        b[15 - k] = _hb(c[32], t[k], c[32], t[15 - k])
    return _stk([ev[..., i] + b[15 - i] for i in range(16)]
                + [ev[..., 15 - i] - b[i] for i in range(16)])


def idct64(x):
    """64-point inverse DCT (only the first 32 inputs may be nonzero)."""
    ev = idct32(x[..., 0::2])
    idx = [1, 33, 17, 49, 9, 41, 25, 57, 5, 37, 21, 53, 13, 45, 29, 61,
           3, 35, 19, 51, 11, 43, 27, 59, 7, 39, 23, 55, 15, 47, 31, 63]
    s = [x[..., i] for i in idx]
    ang = [63, 31, 47, 15, 55, 23, 39, 7, 59, 27, 43, 11, 51, 19, 35, 3]
    b = [None] * 32
    for k in range(16):
        b[k] = _hb(c[ang[k]], s[k], -c[64 - ang[k]], s[31 - k])
        b[31 - k] = _hb(c[64 - ang[k]], s[k], c[ang[k]], s[31 - k])
    t = _pairs(b, 0, 16)
    b = _twiddle(t, [(1, 30, 4, False), (2, 29, 4, True),
                     (5, 26, 36, False), (6, 25, 36, True),
                     (9, 22, 20, False), (10, 21, 20, True),
                     (13, 18, 52, False), (14, 17, 52, True)])
    t = _groups(b, 0, 4, 8)
    b = _twiddle(t, [(2, 29, 8, False), (3, 28, 8, False),
                     (4, 27, 8, True), (5, 26, 8, True),
                     (10, 21, 40, False), (11, 20, 40, False),
                     (12, 19, 40, True), (13, 18, 40, True)])
    t = _groups(b, 0, 8, 4)
    b = _twiddle(t, [(4, 27, 16, False), (5, 26, 16, False),
                     (6, 25, 16, False), (7, 24, 16, False),
                     (8, 23, 16, True), (9, 22, 16, True),
                     (10, 21, 16, True), (11, 20, 16, True)])
    t = _groups(b, 0, 16, 2)
    b = list(t)
    for k in range(8, 16):
        b[k] = _hb(-c[32], t[k], c[32], t[31 - k])
        b[31 - k] = _hb(c[32], t[k], c[32], t[31 - k])
    return _stk([ev[..., i] + b[31 - i] for i in range(32)]
                + [ev[..., 31 - i] - b[i] for i in range(32)])


def iadst4(x):
    x0, x1, x2, x3 = (x[..., i] for i in range(4))
    sp = _SINPI
    s0, s1, s2 = sp[1] * x0, sp[2] * x0, sp[3] * x1
    s3, s4, s5, s6 = sp[4] * x2, sp[1] * x2, sp[2] * x3, sp[4] * x3
    b7 = (x0 - x2) + x3
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = sp[3] * b7
    s0 = s0 + s5
    s1 = s1 - s6
    return _stk([_r2(s0 + s3, 12), _r2(s1 + s3, 12), _r2(s2, 12),
                 _r2(s0 + s1 - s3, 12)])


def iadst8(x):
    s = [x[..., i] for i in (7, 0, 5, 2, 3, 4, 1, 6)]
    b0 = _hb(c[4], s[0], c[60], s[1])
    b1 = _hb(c[60], s[0], -c[4], s[1])
    b2 = _hb(c[20], s[2], c[44], s[3])
    b3 = _hb(c[44], s[2], -c[20], s[3])
    b4 = _hb(c[36], s[4], c[28], s[5])
    b5 = _hb(c[28], s[4], -c[36], s[5])
    b6 = _hb(c[52], s[6], c[12], s[7])
    b7 = _hb(c[12], s[6], -c[52], s[7])
    s0, s1, s2, s3 = b0 + b4, b1 + b5, b2 + b6, b3 + b7
    s4, s5, s6, s7 = b0 - b4, b1 - b5, b2 - b6, b3 - b7
    b4 = _hb(c[16], s4, c[48], s5)
    b5 = _hb(c[48], s4, -c[16], s5)
    b6 = _hb(-c[48], s6, c[16], s7)
    b7 = _hb(c[16], s6, c[48], s7)
    t0, t1, t2, t3 = s0 + s2, s1 + s3, s0 - s2, s1 - s3
    t4, t5, t6, t7 = b4 + b6, b5 + b7, b4 - b6, b5 - b7
    b2 = _hb(c[32], t2, c[32], t3)
    b3 = _hb(c[32], t2, -c[32], t3)
    b6 = _hb(c[32], t6, c[32], t7)
    b7 = _hb(c[32], t6, -c[32], t7)
    return _stk([t0, -t4, b6, -b2, b3, -b7, t5, -t1])


def iadst16(x):
    s = [x[..., i] for i in (15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12,
                             1, 14)]
    ang = [2, 10, 18, 26, 34, 42, 50, 58]
    b = []
    for k in range(8):
        a = ang[k]
        b.append(_hb(c[a], s[2 * k], c[64 - a], s[2 * k + 1]))
        b.append(_hb(c[64 - a], s[2 * k], -c[a], s[2 * k + 1]))
    t = [b[i] + b[i + 8] for i in range(8)] + [b[i] - b[i + 8] for i in range(8)]
    b = list(t)
    b[8] = _hb(c[8], t[8], c[56], t[9])
    b[9] = _hb(c[56], t[8], -c[8], t[9])
    b[10] = _hb(c[40], t[10], c[24], t[11])
    b[11] = _hb(c[24], t[10], -c[40], t[11])
    b[12] = _hb(-c[56], t[12], c[8], t[13])
    b[13] = _hb(c[8], t[12], c[56], t[13])
    b[14] = _hb(-c[24], t[14], c[40], t[15])
    b[15] = _hb(c[40], t[14], c[24], t[15])
    t = [b[i] + b[i + 4] for i in range(4)] + [b[i] - b[i + 4] for i in range(4)]
    t += [b[8 + i] + b[12 + i] for i in range(4)] + [b[8 + i] - b[12 + i] for i in range(4)]
    b = list(t)
    for base in (4, 12):
        b[base + 0] = _hb(c[16], t[base + 0], c[48], t[base + 1])
        b[base + 1] = _hb(c[48], t[base + 0], -c[16], t[base + 1])
        b[base + 2] = _hb(-c[48], t[base + 2], c[16], t[base + 3])
        b[base + 3] = _hb(c[16], t[base + 2], c[48], t[base + 3])
    t = []
    for base in (0, 4, 8, 12):
        t += [b[base] + b[base + 2], b[base + 1] + b[base + 3],
              b[base] - b[base + 2], b[base + 1] - b[base + 3]]
    b = list(t)
    for base in (2, 6, 10, 14):
        b[base] = _hb(c[32], t[base], c[32], t[base + 1])
        b[base + 1] = _hb(c[32], t[base], -c[32], t[base + 1])
    return _stk([b[0], -b[8], b[12], -b[4], b[6], -b[14], b[10], -b[2],
                 b[3], -b[11], b[15], -b[7], b[5], -b[13], b[9], -b[1]])


def iidentity(x, n):
    if n == 4:
        return _r2(x * SQRT2, 12)
    if n == 8:
        return x * 2
    if n == 16:
        return _r2(x * 2 * SQRT2, 12)
    if n == 32:
        return x * 4
    raise ValueError(n)


_IDCT = {4: idct4, 8: idct8, 16: idct16, 32: idct32, 64: idct64}
_IADST = {4: iadst4, 8: iadst8, 16: iadst16}


def _apply_1d(kind: str, x, n: int):
    if kind == "dct":
        return _IDCT[n](x)
    if kind == "adst":
        return _IADST[n](x)
    return iidentity(x, n)


def _lim(bit_depth: int) -> int:
    return 1 << (15 if bit_depth == 8 else bit_depth + 7)


def inv_txfm_plain(coeffs: torch.Tensor, tx_type: int, bit_depth: int = 8,
                   pred=None, tx64: bool = False) -> torch.Tensor:
    """Plain PyTorch inverse transform of one tx type: (..., h, w) int32
    dequantised coefficients -> (..., h, w) int32 residual; with tx64 the
    coefficients are the (..., 32, 32) corner of a 64x64 transform (the
    rest zero); with pred (the output's shape) the reconstruction
    clamp(pred + residual, 0, 2^bit_depth - 1)."""
    if tx64:
        coeffs = torch.nn.functional.pad(coeffs.to(torch.int32),
                                         (0, 32, 0, 32))
    h, w = coeffs.shape[-2], coeffs.shape[-1]
    vert, horz, flip_v, flip_h = tn._TX1D[tx_type]
    row_shift, col_shift = tn._inv_shifts(w, h)
    x = coeffs.to(torch.int32)
    if abs(int(np.log2(w)) - int(np.log2(h))) == 1:
        x = _r2(x * INV_SQRT2, 12)
    x = _apply_1d(horz, x, w)
    if row_shift:
        x = _r2(x, row_shift)
    lim = _lim(bit_depth)
    x = torch.clamp(x, -lim, lim - 1)
    x = _apply_1d(vert, x.transpose(-1, -2), h).transpose(-1, -2)
    x = _r2(x, col_shift)
    if flip_v:
        x = torch.flip(x, dims=[-2])
    if flip_h:
        x = torch.flip(x, dims=[-1])
    if pred is not None:
        x = torch.clamp(pred + x, 0, (1 << bit_depth) - 1)
    return x.contiguous()


def inv_txfm_types_plain(coeffs: torch.Tensor, tx_type, bit_depth: int = 8,
                         pred=None, tx64: bool = False) -> torch.Tensor:
    """inv_txfm's plain route: inv_txfm_plain once per tx type present
    where tx_type is a tensor of per-block types."""
    if not torch.is_tensor(tx_type):
        return inv_txfm_plain(coeffs, int(tx_type), bit_depth, pred, tx64)
    batch = coeffs.shape[:-2]
    hw = (64, 64) if tx64 else tuple(coeffs.shape[-2:])
    out = torch.empty(batch + hw, dtype=torch.int32, device=coeffs.device)
    types = tx_type.to(coeffs.device).expand(batch)
    for t in torch.unique(types).tolist():
        sel = types == t
        out[sel] = inv_txfm_plain(coeffs[sel], t, bit_depth,
                                  None if pred is None
                                  else pred.expand(batch + hw)[sel], tx64)
    return out


_INV_SIZES = {(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
              (8, 16), (16, 8), (16, 32), (32, 16), (32, 64), (64, 32),
              (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16)}
# a K3 launch's pointer and integer arguments, read by the C entry before
# it returns: one buffer of each serves a thread's launches
_INV_ARGS = threading.local()


def inv_txfm(coeffs: torch.Tensor, tx_type, bit_depth: int = 8, pred=None,
             tx64: bool = False) -> torch.Tensor:
    """Normative inverse transform (K3).  coeffs: (..., h, w) int32;
    tx_type: one int for the whole batch, or an int32 tensor broadcast to
    the batch shape with one type per transform.  tx64: coeffs are the
    (..., 32, 32) coded corner of 64x64 transforms (the rest zero), and
    the output is (..., 64, 64).  pred: where given (the output's shape),
    the output is the reconstruction clamp(pred + residual, 0,
    2^bit_depth - 1) instead of the residual.  Bit-exact with
    transforms_jax.inv_txfm (plus the clamp).

    On the card one launch: the coefficients and per-block types are read
    in place where their layout allows (block_layout: a contiguous batch,
    broadcast types), else copied."""
    h, w = coeffs.shape[-2], coeffs.shape[-1]
    if tx64 and (h, w) != (32, 32):
        raise ValueError("inv_txfm: tx64 takes (..., 32, 32) coefficients")
    if coeffs.device.type == "cpu":
        return inv_txfm_types_plain(coeffs, tx_type, bit_depth, pred, tx64)
    key = (_signature(coeffs), _signature(tx_type), _signature(pred), tx64,
           bit_depth)
    plan = _INV_PLANS.get(key)
    if plan is None:
        plan, coeffs, tx_type, pred = _inv_plan(coeffs, tx_type, bit_depth,
                                                pred, tx64, key)
    ptrs = (coeffs.data_ptr(), kernels.ptr(tx_type if torch.is_tensor(tx_type)
                                           else None), kernels.ptr(pred))
    if ptrs[0] % 16 or (pred is not None and ptrs[2] % 16):
        # a view whose first element misses the 16-byte grid: re-plan,
        # copying it (and keep no plan for such a call)
        plan, coeffs, tx_type, pred = _inv_plan(coeffs.clone(), tx_type,
                                                bit_depth, None if pred is None
                                                else pred.clone(), tx64, None)
        ptrs = (coeffs.data_ptr(), ptrs[1], kernels.ptr(pred))
    out_shape, ints = plan
    out = torch.empty(out_shape, dtype=torch.int32, device=coeffs.device)
    bufs = getattr(_INV_ARGS, "bufs", None)
    if bufs is None:
        bufs = _INV_ARGS.bufs = ((ctypes.c_void_p * 4)(),
                                 (ctypes.c_int * 15)())
    bufs[0][:] = ptrs + (out.data_ptr(),)
    bufs[1][:] = ints if torch.is_tensor(tx_type) else (
        ints[:10] + (int(tx_type),) + ints[11:])
    kernels.launch("inv_txfm", coeffs, *bufs)
    return out


# each call shape's launch plan (the output shape and the launch's
# integers) by its inputs' shapes, strides, types and devices; a bounded
# cache of the calls whose inputs are read in place
_INV_PLANS: dict = {}


def _inv_plan(coeffs, tx_type, bit_depth: int, pred, tx64: bool, key):
    """(plan, coeffs, tx_type, pred) of a K3 call: the inputs as the kernel
    reads them (in place where block_layout allows, else copied) and the
    plan (output shape, the 15 launch integers with tx0 0 for per-block
    types), kept under `key` when nothing was copied."""
    h, w = coeffs.shape[-2], coeffs.shape[-1]
    H, W = (64, 64) if tx64 else (h, w)
    if (W, H) not in _INV_SIZES:
        raise ValueError(f"inv_txfm: no kernel for {w}x{h}")
    batch = coeffs.shape[:-2]
    didx = coeffs.get_device()
    copied = False
    x, lay = (_per_block(coeffs, batch, torch.int32, didx, h) if h == w
              else (coeffs, None))
    if lay is None or lay[2] % 4 or x is not coeffs:
        x = coeffs.to(torch.int32).contiguous()
        lay = (1, max(x.numel() // (h * w), 1), h * w)
        copied = x is not coeffs
    nb = 1
    for d in batch:
        nb *= d
    out_shape = batch + (H, W)
    tl, tx0 = (1, 1, 0), 0
    if torch.is_tensor(tx_type):
        t, tl = _per_block(tx_type, batch, torch.int32, didx)
        copied |= t is not tx_type
        tx_type = t
    else:
        tx0 = int(tx_type)
    if pred is not None and (pred.shape != out_shape
                             or pred.dtype != torch.int32
                             or not pred.is_contiguous()
                             or pred.get_device() != didx):
        pred = pred.to(device=x.device, dtype=torch.int32).expand(
            out_shape).contiguous()
        copied = True
    row_shift, col_shift = tn._inv_shifts(W, H)
    plan = (out_shape, (nb, W, H, int(tx64)) + tuple(lay) + tuple(tl) + (
        tx0, row_shift, col_shift, _lim(bit_depth), (1 << bit_depth) - 1))
    if key is not None and not copied:
        if len(_INV_PLANS) >= 4096:
            _INV_PLANS.clear()
        _INV_PLANS[key] = plan
    return plan, x, tx_type, pred


def fwd_mats(tx_type: int, w: int, h: int):
    """(Fv, FhT) float32 forward-transform matrices (numpy), the same basis
    the native path uses (transforms_np._fwd_mats), scale folded in."""
    Fv, FhT, scale = tn._fwd_mats(tx_type, w, h)
    return (np.asarray(Fv * np.sqrt(scale), np.float32),
            np.asarray(FhT * np.sqrt(scale), np.float32))


def fdct_plain(resid: torch.Tensor, Fv: torch.Tensor,
               FhT: torch.Tensor) -> torch.Tensor:
    """(..., n, n) int32 residual -> int32 coefficients: fp32 Fv . x . FhT,
    rounded half to even.  x . FhT is taken first: on the CPU that order
    lands on the same side of .5 as the JAX package's einsum more often
    than the other one does."""
    y = torch.matmul(Fv, torch.matmul(resid.to(torch.float32), FhT))
    return torch.round(y).to(torch.int32)


def _q_grid(shape2, dc_q, ac_q):
    h, w = shape2
    dc = dc_q[..., None, None]
    ac = ac_q[..., None, None]
    pos00 = torch.zeros((h, w), dtype=torch.bool, device=dc.device)
    pos00[0, 0] = True
    return torch.where(pos00, dc, ac)


def quantize_plain(coeffs, dc_q, ac_q, shift: int):
    """Deadzone quantiser (bias QUANT_BIAS_NUM/32), exact integer division;
    dc_q/ac_q: int32 tensors of the batch shape."""
    q = _q_grid(coeffs.shape[-2:], dc_q, ac_q)
    x = coeffs << shift
    mag = torch.abs(x)
    level = torch.div(mag + ((q * QUANT_BIAS_NUM) >> 5), q,
                      rounding_mode="floor")
    level = torch.clamp(level, max=(1 << 15) - 1)
    return torch.sign(x) * level


def dequantize_plain(levels, dc_q, ac_q, shift: int, bit_depth: int = 8):
    """Normative dequantiser with the 24-bit mask and clamp."""
    q = _q_grid(levels.shape[-2:], dc_q, ac_q)
    mag = (torch.abs(levels) * q) & 0xFFFFFF
    lim = 1 << (bit_depth + 7)
    return torch.clamp(torch.sign(levels) * (mag >> shift), -lim, lim - 1)


def coeff_rate(lv: torch.Tensor) -> torch.Tensor:
    """Rate model (bits) of (..., h, w) levels."""
    a = torch.abs(lv).to(torch.float32)
    nz = (a > 0).sum((-1, -2)).to(torch.float32)
    return RATE_NZ * nz + RATE_MAG * torch.log2(1.0 + a).sum((-1, -2))


def fwd_txq_plain(resid, Fv, FhT, tidx, qdc, qac, shift: int,
                  bit_depth: int = 8, thr=None):
    """Plain version of K2 (integer variant), per-block matrices
    Fv[tidx], FhT[tidx] (one product per matrix pair, as the JAX pass
    runs one fdct_batch per tx type), with the level-1 thinning where
    thr is given."""
    if Fv.shape[0] == 1:
        cf = fdct_plain(resid, Fv[0], FhT[0])
    else:
        m = Fv.shape[-2]
        cf = torch.empty(resid.shape[:-2] + (m, m), dtype=torch.int32,
                         device=resid.device)
        for t in torch.unique(tidx).tolist():
            sel = tidx == t
            cf[sel] = fdct_plain(resid[sel], Fv[t], FhT[t])
    lv = quantize_plain(cf, qdc, qac, shift)
    if thr is not None:
        # the inter race's level-1 thinning (wavefront.py:441-445): drop a
        # +-1 level off DC where float(|cf| << shift) < thr (per block)
        mag = (torch.abs(cf) << shift).to(torch.float32)
        drop = (torch.abs(lv) == 1) & (mag < thr[..., None, None])
        drop[..., 0, 0] = False
        lv = torch.where(drop, torch.zeros_like(lv), lv)
    dq = dequantize_plain(lv, qdc, qac, shift, bit_depth)
    qerr = ((cf - dq) << shift).to(torch.float32)
    return lv, dq, (qerr * qerr).sum((-1, -2)), coeff_rate(lv)


def _as_blocks(x, like, dtype=torch.int32):
    return torch.as_tensor(x, device=like.device).to(dtype).expand(
        like.shape[:-2]).contiguous()


def block_layout(v: torch.Tensor, batch, inner: int = 0):
    """How K2 reads a per-block input in place: `v` broadcast to `batch`
    (and, with inner = n, each block an n x n tile with strides (n, 1)).
    Returns (div, mod, stride): block b of the flattened batch starts at
    element ((b // div) % mod) * stride from v.data_ptr().  That holds for
    a view whose batch dimensions are zero-stride ones, then dimensions
    that collapse into one of uniform stride, then zero-stride ones: a
    lane's value repeated over its candidates, one residual over tx
    types, arange(T) keys repeated over the lanes.  None for any other
    layout, which the caller copies.  Read from the shape and strides
    alone (no view is made)."""
    shape, st = v.shape, v.stride()
    nd = len(batch)
    if inner:
        if shape[-2:] != (inner, inner) or (inner > 1 and (
                st[-1] != 1 or st[-2] != inner)):
            return None
        shape, st = shape[:-2], st[:-2]
    if len(shape) > nd:
        return None
    pad = nd - len(shape)
    dims = []
    for i, size in enumerate(batch):
        s_ = shape[i - pad] if i >= pad else 1
        if s_ != size and s_ != 1:
            return None
        if size != 1:
            dims.append((size, st[i - pad] if s_ == size else 0))
    div = 1
    while dims and dims[-1][1] == 0:
        div *= dims.pop()[0]
    while dims and dims[0][1] == 0:
        dims.pop(0)
    if not dims:
        return 1, 1, 0
    mod = 1
    prev = None
    for size, d in dims:
        if d == 0 or (prev is not None and prev != d * size):
            return None
        mod *= size
        prev = d
    return div, mod, dims[-1][1]


def _per_block(v, batch, dtype, device: int, inner=0):
    """(tensor, (div, mod, stride)) of a per-block input for the kernel:
    the view itself where block_layout reads it in place, else a copy
    broadcast to the batch (and made `dtype`, on CUDA device index
    `device`)."""
    if v.get_device() != device:
        v = v.to(f"cuda:{device}")
    if v.dtype == dtype:
        lay = block_layout(v, batch, inner)
        if lay is not None:
            return v, lay
    shape = tuple(batch) + ((inner, inner) if inner else ())
    c = v.to(dtype).expand(shape).contiguous()
    return c, (1, c.numel() // max(inner, 1) ** 2, max(inner, 1) ** 2)


def fwd_txq(resid: torch.Tensor, Fv: torch.Tensor, FhT: torch.Tensor,
            qdc, qac, shift: int, tidx=None, bit_depth: int = 8, thr=None,
            levels: bool = True):
    """Fused forward transform, quantise, dequantise and RD sums (K2).

    resid: (..., n, n) int32; Fv: (T, m, n) and FhT: (T, n, m) float32
    matrix stacks (m = n, or 32 for the 64-point DCT's coded corner);
    tidx: per-block index into the stacks (None: all blocks use entry 0);
    qdc/qac: quantisers (ints, or tensors broadcast over the batch
    shape); thr: float32 level-1 thinning thresholds broadcast over the
    batch shape (None: no thinning; launches with one count under
    "fwd_txq_thin").  Returns (levels, dequantised) int32 (..., m, m), and
    float32 per-block tx-domain SSE sum(((c - dq) << shift)^2) and
    coeff_rate(levels).  With levels=False the call is sums-only: the
    first two are None and the kernel writes neither.

    On the card broadcast views (expanded quantisers, thresholds, keys
    and residuals) are read in place (block_layout) in one launch."""
    n = resid.shape[-1]
    m = Fv.shape[-2]
    batch = resid.shape[:-2]
    if not resid.is_cuda:
        ti = (torch.zeros(batch, dtype=torch.int32) if tidx is None
              else _as_blocks(tidx, resid))
        out = fwd_txq_plain(
            resid, Fv, FhT, ti, _as_blocks(qdc, resid),
            _as_blocks(qac, resid), shift, bit_depth,
            None if thr is None else _as_blocks(thr, resid, torch.float32))
        return out if levels else (None, None) + out[2:]
    lv = dq = None
    if levels:
        lv, dq = resid.new_empty((2,) + batch + (m, m),
                                 dtype=torch.int32).unbind(0)
    dist, rate = resid.new_empty((2,) + batch,
                                 dtype=torch.float32).unbind(0)
    _launch_fwd(resid, batch, n, m, Fv, FhT, tidx, qdc, qac, shift,
                bit_depth, 0, lv, dq, dist, rate, None, thr)
    return lv, dq, dist, rate


_KERNEL_SHAPES = ((4, 4), (8, 8), (16, 16), (32, 32), (64, 32))
# the pointer and integer arguments of a K2 launch, read by the C entry
# before it returns: one buffer of each serves a thread's launches
_ARGS = threading.local()
# each call shape's launch plan (its layout and size ints), by the shapes,
# strides, types and devices of its inputs; a bounded cache
_PLANS: dict = {}


def _launch_fwd(resid, batch, n, m, Fv, FhT, tidx, qdc, qac, shift,
                bit_depth, float_floor, lv, dq, dist, rate, nnz, thr=None):
    """One K2 launch over the blocks of `resid` (batch shape `batch`):
    every per-block input read in place where its layout allows
    (block_layout), the quantisers passed as values where they are
    Python ints.  The layout of a call whose inputs are all read in place
    is kept by their shapes, strides, types and devices (_PLANS), so a
    repeated call shape costs a dictionary lookup."""
    ins = (resid, Fv, FhT, tidx, qdc, qac, thr)
    key = tuple(map(_signature, ins))
    plan = _PLANS.get(key)
    held = []  # copies made here live until the launch is enqueued
    if plan is None:
        plan, ins = _plan(ins, batch, n, m, held)
        if not held:
            if len(_PLANS) >= 4096:
                _PLANS.clear()
            _PLANS[key] = plan
    ptrs = [None if v is None or not torch.is_tensor(v) else v.data_ptr()
            for v in ins]
    bufs = getattr(_ARGS, "bufs", None)
    if bufs is None:
        bufs = _ARGS.bufs = ((ctypes.c_void_p * 12)(), (ctypes.c_int * 25)())
    bufs[1][:] = plan + (0 if ptrs[4] else int(qdc),
                         0 if ptrs[5] else int(qac), shift, QUANT_BIAS_NUM,
                         1 << (bit_depth + 7), float_floor)
    bufs[0][:] = ptrs + [None if o is None else o.data_ptr()
                         for o in (lv, dq, dist, rate, nnz)]
    kernels.launch("fwd_txq", resid, *bufs, RATE_NZ, RATE_MAG,
                   count="fwd_txq" if thr is None else "fwd_txq_thin")


def _signature(v):
    return ((v.shape, v.stride(), v.dtype, v.get_device())
            if torch.is_tensor(v) else type(v))


def _plan(ins, batch, n, m, held):
    """(the launch's layout and size ints, the inputs as the kernel reads
    them): the matrices made contiguous float32, every per-block input
    through _per_block; copies are appended to `held`."""
    resid, Fv, FhT = ins[:3]
    didx = resid.get_device()
    mats = []
    for a in (Fv, FhT):
        if a.dtype != torch.float32 or a.get_device() != didx or \
                not a.is_contiguous():
            a = a.to(device=resid.device, dtype=torch.float32).contiguous()
            held.append(a)
        mats.append(a)
    T = mats[0].shape[0]
    if ((n, m) not in _KERNEL_SHAPES or mats[0].shape != (T, m, n)
            or mats[1].shape != (T, n, m)):
        raise ValueError(f"fwd_txq: no kernel for n={n}, m={m} and matrix "
                         f"stacks {tuple(Fv.shape)}, {tuple(FhT.shape)}")
    x, lay = _per_block(resid, batch, torch.int32, didx, n)
    if x is not resid:
        held.append(x)
    out = [x] + mats
    for v, dt in zip(ins[3:], (torch.int32, torch.int32, torch.int32,
                               torch.float32)):
        if v is None or not torch.is_tensor(v):
            lay += (1, 1, 0)
            out.append(v)
            continue
        c, vl = _per_block(v, batch, dt, didx)
        if c is not v:
            held.append(c)
        out.append(c)
        lay += vl
    nb = 1
    for d in batch:
        nb *= d
    return lay + (nb, n, m, T), out


def fwd_rd_float_plain(resid, Fv, FhT, dc_q: int, ac_q: int, shift: int):
    """Plain version of K2's float-floor variant (device_pipeline
    rd_analysis's quantiser): unrounded fp32 coefficients, level =
    floor((|c| + q' 13/32) / q') with q' = q / 2^shift."""
    n = resid.shape[-1]
    y = torch.matmul(torch.matmul(Fv, resid.to(torch.float32)), FhT)
    qm = torch.full((n, n), float(ac_q), dtype=torch.float32,
                    device=resid.device)
    qm[0, 0] = float(dc_q)
    qm = qm / (1 << shift)
    mag = torch.abs(y)
    level = torch.floor((mag + qm * (13.0 / 32.0)) / qm)
    err = (mag - level * qm) * (1 << shift)
    dist = (err * err).sum((-1, -2))
    nnz = (level > 0).sum((-1, -2)).to(torch.int32)
    rate = RATE_NZ * nnz.to(torch.float32) + RATE_MAG * torch.log2(
        1.0 + level).sum((-1, -2))
    return dist, rate, nnz


def fwd_rd_float(resid: torch.Tensor, Fv: torch.Tensor, FhT: torch.Tensor,
                 dc_q: int, ac_q: int, shift: int):
    """K2, float-floor variant: per-block (unscaled tx-domain SSE, rate,
    nnz) of (..., n, n) int32 residuals under one (n, n) DCT pair."""
    if not resid.is_cuda:
        return fwd_rd_float_plain(resid, Fv, FhT, dc_q, ac_q, shift)
    n = resid.shape[-1]
    batch = resid.shape[:-2]
    dist, rate = resid.new_empty((2,) + batch,
                                 dtype=torch.float32).unbind(0)
    nnz = resid.new_empty(batch, dtype=torch.int32)
    _launch_fwd(resid, batch, n, n, Fv[None], FhT[None], None, int(dc_q),
                int(ac_q), shift, 8, 1, None, None, dist, rate, nnz)
    return dist, rate, nnz
