"""K3 inv_txfm's modes against the JAX package, on the CPU.

The wrapper (rav1e_tpu_torch/ops/transforms.py inv_txfm) runs its plain
route for CPU tensors; the same numpy inputs, made from one seed, go
through it and through transforms_jax.inv_txfm.  The inverse transform is
normative and integer: the tolerance is zero everywhere.

- pred=: the fused reconstruction, clamp(pred + residual, 0, 2^bd - 1),
  equals JAX's inv_txfm plus that clamp, for every tx type each size
  allows (ADST up to 16, identity up to 32), square and rectangular, one
  type a call or a type a block (broadcast, as the pass's races pass
  them).
- tx64=True: the 64x64 transform of a 32x32 coefficient block equals
  JAX's on the zero-padded 64x64 block, with and without pred.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.ops import transforms_jax as tj
from rav1e_tpu.ops import transforms_np as jtn
from rav1e_tpu_torch.ops import transforms as tt

torch.set_num_threads(1)

SEED = 20261018


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_inv(x, tx, bd):
    """transforms_jax.inv_txfm run eagerly: a jit compile a type and size
    would take ~1 s each."""
    return tj.inv_txfm(x, tx, bd)


def _types_for(w, h):
    """The tx types a w x h transform allows (transforms_jax's 1-D sets:
    ADST up to 16 points, identity up to 32)."""
    out = []
    for t in range(16):
        vert, horz, _fv, _fh = jtn._TX1D[t]
        if all(k == "dct" or (k == "adst" and m <= 16)
               or (k == "id" and m <= 32)
               for k, m in ((vert, h), (horz, w))):
            out.append(t)
    return out


def _case(rng, shape, bd):
    x = rng.integers(-(1 << 12), 1 << 12, shape).astype(np.int32)
    pred = rng.integers(0, 1 << bd, shape[:-2] + (shape[-2], shape[-1]))
    return x, pred.astype(np.int32)


@pytest.mark.parametrize("w,h,bd", [(4, 4, 8), (8, 8, 8), (16, 16, 8),
                                    (32, 32, 8), (16, 8, 8), (4, 16, 8),
                                    (8, 8, 10)])
def test_fused_epilogue_matches_jax(w, h, bd):
    rng = np.random.default_rng(SEED + w + 7 * h + bd)
    maxval = (1 << bd) - 1
    for t in _types_for(w, h):
        x, pred = _case(rng, (3, h, w), bd)
        ref = np.asarray(_jax_inv(jnp.asarray(x), t, bd))
        got = tt.inv_txfm(_t(x), t, bd, pred=_t(pred)).numpy()
        assert np.array_equal(got, np.clip(pred + ref, 0, maxval)), t
        assert np.array_equal(tt.inv_txfm(_t(x), t, bd).numpy(), ref), t


@pytest.mark.parametrize("n", [8, 16])
def test_per_block_types_with_pred(n):
    """A type a block, broadcast over the lanes (the pass's 5-type luma
    race), with the fused epilogue: each block as its own type's call."""
    rng = np.random.default_rng(SEED + 100 + n)
    types = _types_for(n, n)[::3]
    x, pred = _case(rng, (4, len(types), n, n), 8)
    ty = _t(np.asarray(types, np.int32)).expand(4, len(types))
    got = tt.inv_txfm(_t(x), ty, 8, pred=_t(pred)).numpy()
    for k, t in enumerate(types):
        ref = np.asarray(_jax_inv(jnp.asarray(x[:, k]), t, 8))
        assert np.array_equal(got[:, k], np.clip(pred[:, k] + ref, 0, 255)), t


@pytest.mark.parametrize("bd", [8, 10])
def test_tx64_matches_jax_on_the_padded_block(bd):
    """(B, 32, 32) coded corners -> (B, 64, 64): JAX's TX_64X64 of the
    zero-padded blocks, residual and reconstruction."""
    rng = np.random.default_rng(SEED + 200 + bd)
    x32 = rng.integers(-(1 << 13), 1 << 13, (3, 32, 32)).astype(np.int32)
    x64 = np.zeros((3, 64, 64), np.int32)
    x64[:, :32, :32] = x32
    pred = rng.integers(0, 1 << bd, (3, 64, 64)).astype(np.int32)
    ref = np.asarray(_jax_inv(jnp.asarray(x64), jtn.DCT_DCT, bd))
    got = tt.inv_txfm(_t(x32), jtn.DCT_DCT, bd, tx64=True).numpy()
    assert got.shape == (3, 64, 64)
    assert np.array_equal(got, ref)
    rec = tt.inv_txfm(_t(x32), jtn.DCT_DCT, bd, pred=_t(pred),
                      tx64=True).numpy()
    assert np.array_equal(rec, np.clip(pred + ref, 0, (1 << bd) - 1))


def test_tx64_takes_only_32x32():
    with pytest.raises(ValueError, match="32, 32"):
        tt.inv_txfm(torch.zeros((1, 64, 64), dtype=torch.int32), 0,
                    tx64=True)
