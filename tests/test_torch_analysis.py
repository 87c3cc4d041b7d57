"""The port's source-edge analysis functions against the JAX package, on
the CPU (the kernels' plain versions): every result identical.

- K12 (`models/device_pipeline.py mode_sad`): `mode_analysis` at n = 8,
  16 and 32 on noisy planes and on planes of flat patches (where the
  candidates tie and the first least one wins), `frame_mode_maps`,
  `intra_analysis_step` at three quantizer indices, and the sharded
  steps over 2, 3 and 4 CPU slots of a `parallel/mesh.py` Mesh against
  the JAX package's on its 4-device virtual mesh and against the
  unsharded maps (slabs whose heights are not a multiple of 64 among
  them).
- K13 (`ops/intra.py dr_predict_batch`) at every one of the 56
  directional angles, square and rectangular; `predict_stack` (K1 and
  K13) at n = 4 to 32.
- K14 (`ops/intra.py build_edges_batch`) over availability patterns, at
  the plane's edges too.
- `ops/mc.py put_single_batch` (K9) on luma, 4:2:0 chroma, 10 bits and
  the SMOOTH and SHARP filter sets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.models import device_pipeline as jdp
from rav1e_tpu.ops import intra_jax as jij
from rav1e_tpu.ops import mc_jax as jmc
from rav1e_tpu.parallel import mesh as jmesh
from rav1e_tpu_torch.models import device_pipeline as tdp
from rav1e_tpu_torch.ops import intra as tij
from rav1e_tpu_torch.ops import mc as tmc
from rav1e_tpu_torch.parallel import mesh as tmesh

# one intra-op thread: the suite runs several test processes side by
# side on the CPU
torch.set_num_threads(1)

SEED = 20261018
# every directional angle: 8 modes x 7 deltas of 3 degrees
ANGLES = tij.DIR_ANGLES.reshape(-1)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_programs():
    """Free the JAX programs this module compiled when it ends: each of
    the suite's worker processes runs many modules, and their compiled
    programs would otherwise stay resident for the rest of the run."""
    yield
    jax.clear_caches()


def _plane(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    """A (h, w) int32 plane of noise, or of flat 64x64 patches (inside a
    patch every candidate predicts the patch's value: they tie at SAD 0),
    or of flat 16x16 patches with a little noise."""
    rng = np.random.default_rng(seed)
    if kind == "noisy":
        return rng.integers(0, 256, (h, w)).astype(np.int32)
    k = 64 if kind == "flat" else 16
    flat = np.kron(rng.integers(0, 256, (-(-h // k), -(-w // k))),
                   np.ones((k, k), np.int64))[:h, :w].astype(np.int32)
    if kind == "flat":
        return flat
    return np.clip(flat + rng.integers(-2, 3, (h, w)), 0, 255).astype(
        np.int32)


def _np(t) -> np.ndarray:
    return np.asarray(t.cpu().numpy() if torch.is_tensor(t) else t)


@pytest.mark.parametrize("kind", ["noisy", "flat"])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_mode_analysis(n, kind):
    y = _plane(kind, 128, 192, SEED + n)
    jm, js = jdp.mode_analysis(jnp.asarray(y), n)
    tm, ts = tdp.mode_analysis(torch.from_numpy(y), n)
    assert np.array_equal(_np(tm), np.asarray(jm))
    assert np.array_equal(_np(ts), np.asarray(js))
    if kind == "flat":
        # inside a patch every candidate ties at 0: the first (DC) wins
        assert ((np.asarray(js) == 0) & (np.asarray(jm) == jdp.DC)).any()


def test_frame_mode_maps():
    y = _plane("patchy", 192, 256, SEED)
    ref = jdp.frame_mode_maps(y)
    got = tdp.frame_mode_maps(y, device="cpu")
    assert set(got) == set(ref) == {32, 16}
    for n in (32, 16):
        for g, r in zip(got[n], ref[n]):
            assert g.dtype == np.int32 and np.array_equal(g, np.asarray(r))
    assert len(np.unique(got[16][0])) > 3


@pytest.mark.parametrize("qidx", [0, 100, 255])
def test_intra_analysis_step(qidx):
    sbs = np.stack([_plane(k, 64, 64, SEED + i) for i, k in
                    enumerate(("noisy", "flat", "patchy") * 2)])
    ref = jdp.intra_analysis_step(jnp.asarray(sbs), jnp.int32(qidx))
    got = tdp.intra_analysis_step(torch.from_numpy(sbs), qidx)
    assert got.shape == (6, 8, 8) and got.dtype == torch.int32
    assert np.array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("slots,n", [(2, 16), (3, 16), (4, 8), (3, 32)])
def test_sharded_mode_analysis(slots, n):
    """Block rows over `slots` CPU slots (with 3 slots at n = 16 the slabs
    are 80, 80 and 96 rows): the maps equal the unsharded ones and the JAX
    package's, sharded over 4 virtual devices (its block rows must divide
    by 4)."""
    y = _plane("patchy", 256, 128, SEED + slots + n)
    mesh = tmesh.make_mesh(4, devices=["cpu"] * slots)
    got = tdp.sharded_mode_analysis(mesh, y, n)
    whole = tdp.mode_analysis(torch.from_numpy(y), n)
    ref = jdp.sharded_mode_analysis(jmesh.make_mesh(4), jnp.asarray(y), n)
    for g, w, r in zip(got, whole, ref):
        assert np.array_equal(_np(g), _np(w))
        assert np.array_equal(_np(g), np.asarray(r))


@pytest.mark.parametrize("slots", [2, 4])
def test_sharded_intra_analysis(slots):
    sbs = np.stack([_plane(("noisy", "flat", "patchy")[i % 3], 64, 64,
                           SEED + 7 * i) for i in range(8)])
    mesh = tmesh.make_mesh(4, devices=["cpu"] * slots)
    got = tdp.sharded_intra_analysis(mesh, sbs, 77)
    ref = jdp.sharded_intra_analysis(jmesh.make_mesh(4), jnp.asarray(sbs),
                                     jnp.int32(77))
    assert np.array_equal(_np(got), np.asarray(ref))
    assert np.array_equal(_np(got), _np(tdp.intra_analysis_step(
        torch.from_numpy(sbs), 77)))


def _edges(rng, B: int, w: int, h: int):
    above = rng.integers(0, 256, (B, 1 + w + h)).astype(np.int32)
    left = rng.integers(0, 256, (B, 1 + w + h)).astype(np.int32)
    left[:, 0] = above[:, 0]
    return above, left


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (32, 32),
                                 (8, 16), (16, 8), (4, 16), (64, 32)])
def test_dr_predict_batch_every_angle(w, h):
    rng = np.random.default_rng(SEED + w * 100 + h)
    above, left = _edges(rng, 2 * len(ANGLES), w, h)
    ang = np.concatenate([ANGLES, rng.permutation(ANGLES)]).astype(np.int32)
    ref = jij.dr_predict_batch(jnp.asarray(above), jnp.asarray(left),
                               jnp.asarray(ang), w, h)
    got = tij.dr_predict_batch(torch.from_numpy(above),
                               torch.from_numpy(left), torch.from_numpy(ang),
                               w, h)
    assert got.shape == (len(ang), h, w) and got.dtype == torch.int32
    assert np.array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_predict_stack(n):
    rng = np.random.default_rng(SEED + n)
    B = 24
    above, left = _edges(rng, B, n, n)
    ha, hl = rng.random(B) < 0.7, rng.random(B) < 0.7
    ref = jij.predict_stack(jnp.asarray(above), jnp.asarray(left), n, n,
                            jnp.asarray(ha), jnp.asarray(hl), 8)
    got = tij.predict_stack(torch.from_numpy(above), torch.from_numpy(left),
                            n, n, torch.from_numpy(ha), torch.from_numpy(hl))
    assert got.shape == (B, 13, n, n)
    assert np.array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("w,h,bd", [(8, 8, 8), (16, 8, 8), (32, 32, 10)])
def test_build_edges_batch(w, h, bd):
    """Every combination of above / left availability, top-right and
    bottom-left reach from none to past the block, and blocks at the
    plane's top, left, right and bottom edges (the clamps)."""
    rng = np.random.default_rng(SEED + w + h + bd)
    H, W = 200, 328
    rec = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
    B = 64
    ys = (rng.integers(0, (H - h) // h + 1, B) * h).astype(np.int32)
    xs = (rng.integers(0, (W - w) // w + 1, B) * w).astype(np.int32)
    ys[:4], xs[:4] = (0, 0, H - h, H - h), (0, W - w, 0, W - w)
    ha = np.arange(B) % 2 == 0
    hl = np.arange(B) % 4 < 2
    n_tr = (rng.integers(0, 3, B) * (w // 2)).astype(np.int32)
    n_bl = (rng.integers(0, 3, B) * (h // 2)).astype(np.int32)
    max_x, max_y = W - 5, H - 3
    ref = jij.build_edges_batch(jnp.asarray(rec), jnp.asarray(ys),
                                jnp.asarray(xs), w, h, jnp.asarray(ha),
                                jnp.asarray(hl), jnp.asarray(n_tr),
                                jnp.asarray(n_bl), max_x, max_y, bd)
    t = torch.from_numpy
    got = tij.build_edges_batch(t(rec), t(ys), t(xs), w, h, t(ha), t(hl),
                                t(n_tr), t(n_bl), max_x, max_y, bd)
    for g, r in zip(got, ref):
        assert g.shape == (B, 1 + w + h) and g.dtype == torch.int32
        assert np.array_equal(_np(g), np.asarray(r))


@pytest.mark.parametrize("case", ["luma", "chroma420", "10bit", "fsets"])
def test_put_single_batch(case):
    rng = np.random.default_rng(SEED + len(case))
    sub, bd, fsets, (w, h) = {
        "luma": (0, 8, (0,), (16, 16)),
        "chroma420": (1, 8, (0,), (8, 8)),
        "10bit": (0, 10, (0, 2), (32, 16)),
        "fsets": (0, 8, (1, 2), (8, 32)),
    }[case]
    rh, rw = 150 >> sub, 200 >> sub
    ref = rng.integers(0, 1 << bd, (rh, rw)).astype(np.int32)
    B = 40
    blocks = np.stack([rng.integers(0, rw - w, B),
                       rng.integers(0, rh - h, B)], 1).astype(np.int32)
    mvs = rng.integers(-160, 161, (B, 2)).astype(np.int32)
    for fset in fsets:
        want = jmc.put_single_batch(ref, blocks, mvs, w, h, sub, sub, bd,
                                    fset)
        got = tmc.put_single_batch(ref, blocks, mvs, w, h, sub, sub, bd,
                                   fset, device="cpu")
        assert got.shape == (B, h, w)
        assert np.array_equal(got, np.asarray(want)), fset
