"""The multi-device half of the port's parallel/ on CPU slots, against the
JAX package.

- `deblock_sharded` (the halo-exchange deblock) over 4 and 8 CPU slots
  against the JAX package's `deblock_sharded` on a 4-device virtual mesh
  and against the port's serial `deblock_np`, at 8, 10 and 12 bits, luma
  and chroma: on tests/test_multichip.py's inputs (uniform noise, on which no
  edge passes the filter masks) and on flat blocks with a little noise,
  where the edges filter.  The JAX function runs its `shard_map` under
  `jax.jit` (the same program compiled once instead of op by op: minutes
  less, the same integers).
- Slabs whose width is not a multiple of 64: the port stays equal to the
  serial deblock; the JAX package tests for transform edges in slab
  coordinates there and does not (ROADMAP F10).
- Row 15: the port's whole-plane `deblock_plane` (plain) against JAX's
  `deblock_plane_jnp`, and `filter_chain_device` against JAX's; K4's slab
  window at x0 = 0 is the whole pass; the envelope raises.
- The Context's slot choice at 1, 2 and 8 visible GPUs, the mesh's
  grouping, and `dryrun_multidevice` on 4 CPU slots.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.ops import deblock_jax as dj
from rav1e_tpu.parallel import mesh as jmesh
from rav1e_tpu.parallel import tiles as jtiles
from rav1e_tpu_torch.ops import deblock as db
from rav1e_tpu_torch.ops import deblock_np as dnp
from rav1e_tpu_torch.parallel import mesh as tmesh
from rav1e_tpu_torch.parallel import tiles as ttiles

# one intra-op thread: the suite runs several test processes side by
# side on the CPU
torch.set_num_threads(1)

LEVELS = (24, 30, 18, 20)  # tests/test_multichip.py's
SHARPNESS = 2


def multichip_inputs(plane_idx, sub):
    """tests/test_multichip.py:75-100's plane and block layout (512x128):
    (plane, info, width, height)."""
    rng = np.random.default_rng(5)
    w, h = 512, 128
    sub_x, sub_y = sub
    pw, ph = w >> sub_x, h >> sub_y
    info = dnp.DeblockInfo(h // 4, w // 4)
    y = 0
    while y < h:
        x = 0
        bh = int(rng.choice([16, 32]))
        while x < w:
            bw = int(rng.choice([16, 32]))
            info.set_block(x, y, bw, bh, bool(rng.integers(0, 2)))
            x += bw
        y += bh
    plane = rng.integers(0, 256, (ph, pw)).astype(np.int32)
    return plane, info, pw, ph


def blocky_inputs(plane_idx, sub, bd, w=1024, h=128, seed=7):
    """Superblocks split into square blocks of 8 to 64 (30% skipped), and
    a plane of flat 8x8 patches with +-1 noise at bit depth bd, so that
    every filter size is taken."""
    rng = np.random.default_rng(seed + bd + plane_idx)
    info = dnp.DeblockInfo(h // 4, w // 4)
    for sy in range(0, h, 64):
        for sx in range(0, w, 64):
            bs = int(rng.choice([8, 16, 32, 64]))
            for y in range(sy, sy + 64, bs):
                for x in range(sx, min(sx + 64, w), bs):
                    info.set_block(x, y, bs, bs, bool(rng.random() < 0.3))
    pw, ph = w >> sub[0], h >> sub[1]
    top = 1 << bd
    base = np.kron(rng.integers(top // 4, 3 * top // 4,
                                (ph // 8 + 1, pw // 8 + 1)),
                   np.ones((8, 8), np.int64))[:ph, :pw]
    step = 1 << (bd - 8)
    plane = np.clip(base + step * rng.integers(-1, 2, (ph, pw)), 0, top - 1)
    return plane.astype(np.int32), info, pw, ph


def serial(plane, info, plane_idx, sub, bd, pw, ph):
    ref = plane.copy()
    dnp.deblock_plane(ref, info, plane_idx, LEVELS, SHARPNESS, *sub, bd, pw,
                      ph)
    return ref


def jax_sharded(plane, info, plane_idx, sub, bd, pw, ph, n=4):
    """rav1e_tpu/parallel/tiles.py deblock_sharded on make_mesh(n) of the
    virtual CPU mesh, its shard_map compiled as one program."""
    orig = jax.shard_map
    jax.shard_map = lambda f, **kw: jax.jit(orig(f, **kw))
    try:
        return jtiles.deblock_sharded(jmesh.make_mesh(n), plane.copy(), info,
                                      LEVELS, SHARPNESS, plane_idx, *sub, bd,
                                      pw, ph)
    finally:
        jax.shard_map = orig


def port_sharded(plane, info, plane_idx, sub, bd, pw, ph, n):
    mesh = tmesh.make_mesh(n, devices=["cpu"] * n)
    return ttiles.deblock_sharded(mesh, plane.copy(), info, LEVELS, SHARPNESS,
                                  plane_idx, *sub, bd, pw, ph)


@functools.lru_cache(maxsize=None)
def case(content, plane_idx, bd):
    """(inputs, the serial result, the JAX sharded result) of one case,
    computed once for its slot counts."""
    sub = (0, 0) if plane_idx == 0 else (1, 1)
    make = multichip_inputs if content == "multichip" else functools.partial(
        blocky_inputs, bd=bd)
    plane, info, pw, ph = make(plane_idx, sub)
    ref = serial(plane, info, plane_idx, sub, bd, pw, ph)
    jout = jax_sharded(plane, info, plane_idx, sub, bd, pw, ph)
    return (plane, info, sub, pw, ph), ref, jout


SHARDED = [("multichip", 0, 8, 4), ("multichip", 0, 8, 8),
           ("multichip", 1, 8, 4)] + [
    ("blocky", p, bd, n) for bd in (8, 10, 12) for p in (0, 1)
    for n in (4, 8)]


@pytest.mark.parametrize("content,plane_idx,bd,n", SHARDED)
def test_deblock_sharded_matches_jax_and_serial(content, plane_idx, bd, n):
    """The port's deblock_sharded on n CPU slots: the JAX package's
    sharded result (4 devices) and the serial deblock_np, exactly.  (The
    256-wide chroma of tests/test_multichip.py's plane has 32-column slabs
    on 8 slots, outside the envelope.)"""
    (plane, info, sub, pw, ph), ref, jout = case(content, plane_idx, bd)
    out = port_sharded(plane, info, plane_idx, sub, bd, pw, ph, n)
    assert out.dtype == np.int32 and out.shape == (ph, pw)
    np.testing.assert_array_equal(jout, ref)
    np.testing.assert_array_equal(out, ref)
    if content == "blocky":
        assert (ref != plane).mean() > 0.02  # the edges filtered


@pytest.mark.parametrize("plane_idx,n", [(0, 8), (0, 4), (1, 4)])
def test_deblock_sharded_off_64_slabs(plane_idx, n):
    """Slabs of 68 or 136 columns (a 544x128 frame): the port equals the
    serial deblock, whose transform edges lie at plane x; the JAX package
    tests them at slab x and so misses edges in every shard but the first
    (ROADMAP F10, witnessed on 4 devices)."""
    sub = (0, 0) if plane_idx == 0 else (1, 1)
    plane, info, pw, ph = blocky_inputs(plane_idx, sub, 8, w=544)
    ref = serial(plane, info, plane_idx, sub, 8, pw, ph)
    assert (pw // n) % 64
    out = port_sharded(plane, info, plane_idx, sub, 8, pw, ph, n)
    np.testing.assert_array_equal(out, ref)
    if plane_idx == 0 and n == 4:
        jout = jax_sharded(plane, info, plane_idx, sub, 8, pw, ph)
        assert not np.array_equal(jout, ref)


def _jnp_plane(plane, info, plane_idx, sub, bd, pw, ph):
    """deblock_jax.py:203 deblock_plane_jnp, jitted over its arrays."""
    fn = jax.jit(lambda p, txw, txh, bx, by, sk: dj.deblock_plane_jnp(
        jnp, p, txw, txh, bx, by, sk, LEVELS, SHARPNESS, plane_idx, *sub, bd,
        pw, ph))
    return np.asarray(fn(jnp.asarray(plane), jnp.asarray(info.txw),
                         jnp.asarray(info.txh), jnp.asarray(info.bx),
                         jnp.asarray(info.by), jnp.asarray(info.skip)))


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("plane_idx", [0, 1])
def test_deblock_plane_matches_jnp(plane_idx, bd):
    """Row 15: the port's whole-plane deblock (K4's plain version, both
    directions) equals deblock_plane_jnp and deblock_np."""
    sub = (0, 0) if plane_idx == 0 else (1, 1)
    plane, info, pw, ph = blocky_inputs(plane_idx, sub, bd, w=256)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    got = db.deblock_plane(t(plane), t(info.txw), t(info.txh), t(info.bx),
                           t(info.by), t(info.skip), plane_idx, *sub,
                           *db.plane_lims(LEVELS, SHARPNESS, plane_idx, bd),
                           bd).numpy()
    ref = serial(plane, info, plane_idx, sub, bd, pw, ph)
    np.testing.assert_array_equal(_jnp_plane(plane, info, plane_idx, sub, bd,
                                             pw, ph), ref)
    np.testing.assert_array_equal(got, ref)
    assert (ref != plane).mean() > 0.02


@pytest.mark.parametrize("bd", [8, 10])
def test_filter_chain_device_matches_jax(bd):
    """Row 15: filter_chain_device (launch + collect in one call) on
    tests/test_torch_ops.py's 320x240 stand-in frame: the JAX package's
    planes at 8 bits; False, the frame untouched, outside the chain's
    8-bit envelope in both packages."""
    from types import SimpleNamespace

    from rav1e_tpu.ops import filter_chain_jax as jfc
    from rav1e_tpu_torch.ops import filter_chain as tfc
    from tests.test_torch_ops import SEED, _chain_frame

    base = _chain_frame(np.random.default_rng(SEED + 1000), 320, 240)
    base["bd"] = bd
    src_dev = jnp.zeros(base["h"] * base["w"] * 3 // 2, jnp.uint8)
    jfe = SimpleNamespace(**base, _src_dev=src_dev)
    jfe.rec = [p.copy() for p in base["rec"]]
    tfe = SimpleNamespace(**base, device="cpu", _wf_dev_out=None)
    tfe.rec = [p.copy() for p in base["rec"]]
    assert tfc.filter_chain_device(tfe) == jfc.filter_chain_device(jfe) == (
        bd == 8)
    for p in range(3):
        assert np.array_equal(tfe.rec[p], jfe.rec[p]), p
    assert np.array_equal(tfe.rec[0], base["rec"][0]) == (bd != 8)


def test_window_at_zero_is_the_whole_pass():
    """K4's slab window: x0 = 0 over the plane's own width is today's pass
    (each direction equal to deblock_np's); a slab whose first and last
    64 columns lie beyond the plane filters only the plane's edges."""
    plane, info, pw, ph = blocky_inputs(0, (0, 0), 8, w=256)
    lim = tuple(int(v) for v in dnp.thresholds(LEVELS[0], SHARPNESS, 8))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    args = (*lim, 8, 0, t(info.txw), t(info.bx), t(info.skip), 0, 0)
    whole = db.deblock_pass_plain(t(plane), *args)
    np.testing.assert_array_equal(
        db.deblock_pass_plain(t(plane), *args, x0=0, width=pw), whole)
    ref = plane.copy()
    dnp._deblock_pass(ref, *lim, 8, 0, pw, ph, info.txw, info.bx, info.skip,
                      0, 0)
    np.testing.assert_array_equal(whole.numpy(), ref)
    # the plane between 64 replicated columns on each side, the halos'
    # maps copied from the plane's edge (transform edges at every 4)
    ext = np.concatenate([np.repeat(plane[:, :1], 64, 1), plane,
                          np.repeat(plane[:, -1:], 64, 1)], 1)
    pad = lambda a, v: np.concatenate([np.full((a.shape[0], 16), v, a.dtype),
                                       a, np.full((a.shape[0], 16), v,
                                                  a.dtype)], 1)
    got = db.deblock_pass_plain(
        t(ext), *lim, 8, 0, t(pad(info.txw, 4)), t(pad(info.bx, 0) + 64),
        t(pad(info.skip, False)), 0, 0, x0=-64, width=pw)
    np.testing.assert_array_equal(got[:, 64:-64].numpy(), ref)
    np.testing.assert_array_equal(got[:, :64].numpy(), ext[:, :64])
    np.testing.assert_array_equal(got[:, -64:].numpy(), ext[:, -64:])


@pytest.mark.parametrize("width,n", [(512, 3), (520, 8), (512, 16)])
def test_deblock_sharded_envelope_raises(width, n):
    """width % n, slabs a multiple of 4 and at least 64 columns wide."""
    plane, info, pw, ph = blocky_inputs(0, (0, 0), 8, w=width, h=64)
    with pytest.raises(ValueError):
        port_sharded(plane, info, 0, (0, 0), 8, pw, ph, n)


@pytest.mark.parametrize("count", [1, 2, 8])
def test_context_slots(count):
    """The Context's slots for threads=4, tile_cols=4 at `count` visible
    GPUs: the first min(4, count) GPUs for an unindexed "cuda" when more
    than one is visible, else one slot on its device."""
    n = 4
    cuda = tmesh.slots_for("cuda", n, count)
    if count == 1:
        assert cuda == [torch.device("cuda")]
    else:
        assert cuda == [torch.device("cuda", i) for i in range(min(n,
                                                                   count))]
    assert tmesh.slots_for("cuda:1", n, count) == [torch.device("cuda:1")]
    assert tmesh.slots_for("cpu", n, count) == [torch.device("cpu")]


def test_mesh_slots():
    """Shards and tile columns laid contiguously over the slots; a slot on
    a device this process cannot reach raises (no slot moves)."""
    m = tmesh.make_mesh(8, devices=["cpu"] * 3)
    assert m.size == 8 and len(m.slots) == 3
    assert [len(r) for _d, r in m.groups(8)] == [2, 3, 3]
    assert [list(r) for _d, r in m.groups(2)] == [[0], [1]]
    assert tmesh.make_mesh(4, "cpu").devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError):
        tmesh.make_mesh(2, devices=["cpu"] * 3)
    if torch.cuda.device_count() < 8:
        with pytest.raises(RuntimeError):
            tmesh.make_mesh(8, devices=[f"cuda:{i}" for i in range(8)])


def test_dryrun_multidevice_on_cpu_slots(capsys):
    """dryrun_multidevice(4) on 4 CPU slots: the tile encode, the sharded
    deblock and the public API each equal their single-device result."""
    from rav1e_tpu_torch.parallel.dryrun import dryrun_multidevice

    line = dryrun_multidevice(4, devices=["cpu"] * 4)
    assert line["multichip_public_api"] == "byte-identical"
    assert line["slots"] == ["cpu"] * 4 and line["context_slots"] == ["cpu"]
    assert '"multichip_public_api"' in capsys.readouterr().out
