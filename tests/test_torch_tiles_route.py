"""The tile route (Config(threads=T) with tile_cols=T) against the JAX
package's sharded route on the virtual mesh, on the CPU.

With threads > 1 and tile_cols > 1 the key frames of both packages run
the wavefront pass over their tile columns (parallel/tiles.py): the JAX
package as a vmap over a mesh of min(threads, tile_cols) devices (the
virtual CPU devices of tests/conftest.py), the port as one pass over the
columns' stacked lanes on its one device.  Inter frames keep the inter
wavefront.  The route's frames have no device-resident source, so both
packages filter them on the host filter path.

The port takes the JAX fdct (its own may round an fp32 tie the other
way) and, where a device filter chain runs, the JAX chain's Wiener taps;
with its own it is held against its own single-device encode, whose bytes
the route must write (the JAX package's contract,
tests/test_multichip.py), also with the psychovisual lambda map or the
segment quantisers on, which the JAX route ignores (ROADMAP F8, fixed in
the port).  The JAX route itself breaks that contract on the second frame of the 512x256 clip: its vmapped pass
decides some superblocks otherwise than its single-device pass (ROADMAP F9,
held by test_jax_route_differs_from_its_single_pass); the port's route
equals the single-device pass there too.

The route's edges: a 320x240 frame (outside the envelope) takes the
single-device pass with no band maps and no batching, as in the JAX
package; a frame with tile rows is accepted at launch and coded by the
host walk.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.ops import transforms_jax as tj
from rav1e_tpu_torch.ops import transforms as tt
from rav1e_tpu_torch.utils.content import make_planes

# one intra-op thread: the suite runs several test processes side by
# side on the CPU
torch.set_num_threads(1)

W, H, T = 512, 256, 4  # 8 x 4 superblocks, 4 tile columns of 2


def _encode(pkg, frames, threads, tile_cols, speed=6, tune="psnr",
            every_key=True, chains=None, segmentation_aq=False, **cfg_kw):
    """Encode `frames` (y, u, v) through Config -> Context of `pkg` at
    bench.py's keyframe settings (quantizer 100, low latency), every frame
    a key frame or (every_key=False) one key frame then P frames.
    Returns a dict: packet bytes, recon per frame, the encoder's key
    routes, the inter frames' (wf_inter, mesh) and the Context.  With
    `chains`, every device filter chain's (taps, en, the CDEF output they
    were solved for)."""
    C = importlib.import_module(pkg + ".api.config")
    X = importlib.import_module(pkg + ".api.context")
    Fr = importlib.import_module(pkg + ".utils.frame")
    IF = importlib.import_module(pkg + ".models.inter_frame")
    h, w = frames[0][0].shape
    kint = 1 if every_key else 64
    cfg = C.Config(enc=C.EncoderConfig(
        width=w, height=h, quantizer=100, min_key_frame_interval=1,
        max_key_frame_interval=kint, rdo_lookahead_frames=8,
        low_latency=True, tune=tune, tile_cols=tile_cols,
        segmentation_aq=segmentation_aq,
        speed_settings=C.SpeedSettings.from_preset(speed)),
        threads=threads, **cfg_kw)
    inter = []
    undo = []
    orig_f = IF.InterFrameEncoder._finish_encode

    def fspy(fe):
        inter.append((bool(fe.wf_inter), getattr(fe, "wavefront_mesh", None)))
        return orig_f(fe)

    IF.InterFrameEncoder._finish_encode = fspy
    undo.append((IF.InterFrameEncoder, "_finish_encode", orig_f))
    if chains is not None:
        from rav1e_tpu.ops import filter_chain_jax as jfc

        orig_c = jfc.collect_filter_chain

        def cspy(fe, handle):
            done = orig_c(fe, handle)
            chains.append((np.asarray(fe._chain_lr[2]),
                           np.asarray(fe._chain_lr[3]),
                           [p.copy() for p in fe.rec]))
            return done

        jfc.collect_filter_chain = cspy
        undo.append((jfc, "collect_filter_chain", orig_c))
    try:
        ctx = cfg.new_context()
        pkts = []

        def drain():
            while True:
                try:
                    pkts.append(ctx.receive_packet())
                except X.EncoderError as e:
                    if e.status in (X.EncoderStatus.NEED_MORE_DATA,
                                    X.EncoderStatus.LIMIT_REACHED):
                        return
                    raise

        for y, u, v in frames:
            ctx.send_frame(Fr.Frame.from_planes(y, u, v))
            drain()
        ctx.flush()
        drain()
    finally:
        for owner, name, orig in undo:
            setattr(owner, name, orig)
    stats = ctx._encoder.stats
    return {"data": [p.data for p in pkts],
            "recon": [ctx._encoder.recon_by_input[i]
                      for i in range(len(frames))],
            "routes": dict(getattr(stats, "key_routes", {})),
            "inter": inter, "ctx": ctx}


_fdct_jit = jax.jit(tj.fdct_batch)


def _jax_fdct(resid, Fv, FhT):
    """The JAX package's fdct_batch, as a drop-in for tt.fdct_plain."""
    return torch.from_numpy(np.array(_fdct_jit(
        jnp.asarray(resid.numpy()), jnp.asarray(Fv.numpy()),
        jnp.asarray(FhT.numpy()))))


def _jax_taps(chains):
    """A stand-in for K7's plain version returning, chain by chain, the
    JAX chain's taps after checking it is asked to solve for the JAX
    chain's CDEF output."""
    frames = iter(chains)

    def solve(ds, ss):
        taps, en, rec = next(frames)
        for p, d in enumerate(ds):
            assert np.array_equal(d.numpy(),
                                  rec[p][: d.shape[0], : d.shape[1]]), p
        return (torch.from_numpy(taps.astype(np.int32)),
                torch.from_numpy(en.astype(np.int32)))
    return solve


def _same(a, b, frames=None):
    """Equal packets and recon (of the given frame indices)."""
    idx = range(len(a["recon"])) if frames is None else frames
    for f in idx:
        assert a["data"][f] == b["data"][f], f
        for p in range(3):
            assert np.array_equal(np.asarray(a["recon"][f][p]),
                                  np.asarray(b["recon"][f][p])), (f, p)


def _decodes_to(data, recon):
    from rav1e_tpu_torch.utils import dav1d_oracle as dav1d

    dec = dav1d.decode_stream(data)
    assert len(dec) == len(recon)
    for f, r in enumerate(recon):
        for p in range(3):
            rp = np.asarray(r[p])
            assert np.array_equal(dec[f][p][: rp.shape[0], : rp.shape[1]],
                                  rp.astype(np.uint8)), (f, p)


def _port(frames, threads, tile_cols, jax_fdct=False, monkeypatch=None,
          **kw):
    if jax_fdct:
        with monkeypatch.context() as m:
            m.setattr(tt, "fdct_plain", _jax_fdct)
            return _encode("rav1e_tpu_torch", frames, threads, tile_cols,
                           device="cpu", **kw)
    return _encode("rav1e_tpu_torch", frames, threads, tile_cols,
                   device="cpu", **kw)


# -- 512x256, four tile columns ------------------------------------------------


@pytest.fixture(scope="module")
def clip():
    return make_planes(W, H, 2)


@pytest.fixture(scope="module")
def jax_tiles(clip):
    return _encode("rav1e_tpu", clip, T, T)


@pytest.fixture(scope="module")
def port_tiles(clip):
    return _port(clip, T, T)


def test_two_key_frames_take_the_route(clip, jax_tiles, port_tiles,
                                       monkeypatch):
    """Two key frames, each on the tile route (no batching): the port's
    bytes and recon equal its own single-device encode's; given the JAX
    fdct the first frame's packet is the JAX route's (the second is F9's,
    see test_jax_route_differs_from_its_single_pass)."""
    from rav1e_tpu_torch.models import wavefront as twf

    batches = []
    orig = twf.launch_wavefront_batch
    monkeypatch.setattr(twf, "launch_wavefront_batch",
                        lambda fes, *a: batches.append(len(fes)) or orig(
                            fes, *a))
    own = _port(clip, T, T, jax_fdct=True, monkeypatch=monkeypatch)
    assert own["routes"] == {"tiles": 2}
    assert batches == []
    _same(own, jax_tiles, frames=[0])
    single = _port(clip, 0, T)
    assert single["routes"] == {"single": 2}
    assert port_tiles["routes"] == {"tiles": 2}
    _same(port_tiles, single)


def test_jax_route_differs_from_its_single_pass(clip, monkeypatch):
    """F9: on the clip's second frame the JAX sharded route's records
    differ from the JAX single-device pass's in some superblocks; the
    port's tile pass (given the JAX fdct) equals the single-device pass on
    every superblock of both frames."""
    from rav1e_tpu.api import config as jcfg
    from rav1e_tpu.models import pipeline as jpl
    from rav1e_tpu.models import wavefront as jwf
    from rav1e_tpu.parallel import mesh as jmesh
    from rav1e_tpu.parallel import tiles as jtiles
    from rav1e_tpu_torch.api import config as tcfg
    from rav1e_tpu_torch.models import pipeline as tpl
    from rav1e_tpu_torch.parallel import mesh as tmesh
    from rav1e_tpu_torch.parallel import tiles as ttiles

    monkeypatch.setattr(tt, "fdct_plain", _jax_fdct)
    kw = dict(width=W, height=H, quantizer=100, low_latency=True,
              tile_cols=T, tune="psnr")
    jfe = jpl.FrameEncoder(jcfg.EncoderConfig(**kw))
    tfe = tpl.FrameEncoder(tcfg.EncoderConfig(**kw), device="cpu")

    def records(res):
        return [[tuple(np.asarray(x).tobytes() for x in rec)
                 for rec in res.sb_records(r, c)]
                for r in range(H // 64) for c in range(W // 64)]

    jax_diff = []
    for planes in clip:
        pl = [p.astype(np.int32) for p in planes]
        fe_j = jfe._build_key_encoder(100)
        fe_j.prepare(pl, launch=False)
        fe_t = tfe._build_key_encoder(100)
        fe_t.prepare(pl, launch=False)
        single = jwf.launch_wavefront(fe_j, fe_j._tile_grid()).collect()
        route = jtiles.run_wavefront_sharded(fe_j, fe_j._tile_grid(),
                                             jmesh.make_mesh(T))
        mine = ttiles.run_wavefront_sharded(fe_t, fe_t._tile_grid(),
                                            tmesh.make_mesh(T, "cpu"))
        assert records(mine) == records(single)
        for p in range(3):
            assert np.array_equal(mine.rec[p], single.rec[p]), p
        jax_diff.append(sum(a != b for a, b in zip(records(route),
                                                   records(single))))
    assert jax_diff[0] == 0 and jax_diff[1] > 0, jax_diff


def test_facade_records_match_the_single_pass(clip):
    """The facade's sb_records of every superblock equal the port's
    single-device pass's records of that superblock, frame x-offsets
    included; split maps, 64-root map and recon agree too."""
    from rav1e_tpu_torch.api import config as tcfg
    from rav1e_tpu_torch.models import pipeline as tpl
    from rav1e_tpu_torch.models import wavefront as twf
    from rav1e_tpu_torch.parallel import mesh as tmesh
    from rav1e_tpu_torch.parallel import tiles as ttiles

    fenc = tpl.FrameEncoder(tcfg.EncoderConfig(
        width=W, height=H, quantizer=100, low_latency=True, tile_cols=T,
        tune="psnr"), device="cpu")
    fe = fenc._build_key_encoder(100)
    fe.prepare([p.astype(np.int32) for p in clip[0]], launch=False)
    tiles = fe._tile_grid()
    single = twf.launch_wavefront(fe, tiles).collect()
    route = ttiles.run_wavefront_sharded(fe, tiles, tmesh.make_mesh(T, "cpu"))
    assert route.route == "tiles" and not hasattr(route, "dev_out")
    assert getattr(route, "packed", None) is None
    tw = W // 64 // T
    for r in range(H // 64):
        for c in range(W // 64):
            mine, ref = route.sb_records(r, c), single.sb_records(r, c)
            assert len(mine) == len(ref)
            for a, b in zip(mine, ref):
                assert c // tw * tw * 64 <= a[0] < (c // tw + 1) * tw * 64
                assert all(np.array_equal(np.asarray(x), np.asarray(y))
                           for x, y in zip(a, b)), (r, c)
    assert np.array_equal(route.split_map, single.split_map)
    assert np.array_equal(route.split16_map, single.split16_map)
    dev = single.geom.device_sb
    n64 = np.zeros(dev.shape, bool)
    n64[dev] = single.none64[single.geom.sb_step[dev],
                             single.geom.sb_lane[dev]]
    assert np.array_equal(route.none64_full, n64)
    for p in range(3):
        assert np.array_equal(route.rec[p], single.rec[p])


def _route_equals_single(frames, monkeypatch, grid, **kw):
    """The tile route's lanes carry the frame's per-superblock values
    (lane grid `grid`: 0 lambda, 1 dc_q) where they vary, and its bytes
    and recon equal the port's single-device encode's."""
    from rav1e_tpu_torch.models import wavefront as twf

    grids = []
    orig = twf.pack_upload
    monkeypatch.setattr(twf, "pack_upload",
                        lambda srcs, g, *a: grids.append(g) or orig(srcs, g,
                                                                    *a))
    mine = _port(frames, T, T, **kw)
    assert mine["routes"] == {"tiles": 1}
    route = np.concatenate([g[grid] for g in grids[-1]], axis=1)
    assert (route != route.flat[0]).any()
    single = _port(frames, 0, T, **kw)
    assert single["routes"] == {"single": 1}
    _same(mine, single)


def test_psychovisual_route_has_uniform_lanes(clip, monkeypatch):
    """tune="psychovisual" on the JAX route (F8, unfixed there): it fills
    every lane with the frame's own lambda, so its bytes are the port's
    route's with uniform lane grids (each column given the frame's
    `_uniform_grids`), given the JAX fdct, and differ from the port's
    single-device bytes."""
    from rav1e_tpu_torch.models import wavefront as twf
    from rav1e_tpu_torch.parallel import tiles as ttiles

    one = clip[:1]
    jout = _encode("rav1e_tpu", one, T, T, tune="psychovisual")
    with monkeypatch.context() as m:
        m.setattr(ttiles, "column_grids",
                  lambda fe, geom, t, tw: twf._uniform_grids(fe, geom))
        uniform = _port(one, T, T, jax_fdct=True, monkeypatch=m,
                        tune="psychovisual")
    assert uniform["routes"] == {"tiles": 1}
    _same(uniform, jout)
    single = _port(one, 0, T, tune="psychovisual")
    assert single["data"][0] != uniform["data"][0]


def test_psychovisual_route_writes_single_device_bytes(clip, monkeypatch):
    """tune="psychovisual" (F8, fixed in the port): the route's lanes
    carry the psychovisual lambda map, column by column, and its bytes
    equal the port's single-device bytes."""
    _route_equals_single(clip[:1], monkeypatch, 0, tune="psychovisual")


def test_segmentation_route_writes_single_device_bytes(clip, monkeypatch):
    """segmentation_aq (F8, fixed in the port): the route's lanes carry
    the segment quantisers, and its bytes equal the port's single-device
    bytes."""
    _route_equals_single(clip[:1], monkeypatch, 1, tune="psnr",
                         segmentation_aq=True)


# -- the route's edges ------------------------------------------------------------


def test_outside_the_envelope_single_launch(monkeypatch):
    """320x240 (240 = 3*64 + 48) under threads=2: each key frame takes the
    single-device pass, with no band maps (the mesh skips them) and no
    batched launch, as in the JAX package, whose bytes the port writes
    given the JAX fdct and chain taps."""
    from rav1e_tpu_torch.models import device_pipeline as tdp
    from rav1e_tpu_torch.models import wavefront as twf
    from rav1e_tpu_torch.ops import lrf as tlr

    frames = make_planes(320, 240, 2)
    chains = []
    jout = _encode("rav1e_tpu", frames, 2, 2, chains=chains)
    calls = {"band": 0, "batch": 0}

    def count(name, fn):
        def spy(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return spy

    monkeypatch.setattr(tdp, "launch_band_rd_maps",
                        count("band", tdp.launch_band_rd_maps))
    monkeypatch.setattr(twf, "launch_wavefront_batch",
                        count("batch", twf.launch_wavefront_batch))
    monkeypatch.setattr(tlr, "wiener_solve_plain", _jax_taps(chains))
    mine = _port(frames, 2, 2, jax_fdct=True, monkeypatch=monkeypatch)
    assert mine["routes"] == {"single": 2}
    assert calls == {"band": 0, "batch": 0}
    _same(mine, jout)


def test_tile_rows_take_the_host_walk():
    """256x192 with 2x2 tiles and a mesh: the route accepts the frame at
    launch and declines it at collect, so the host walk codes it; the JAX
    package's bytes and recon."""
    from rav1e_tpu_torch.parallel import tiles as ttiles

    out = {}
    y, u, v = make_planes(256, 192, 1)[0]
    for pkg, kw in (("rav1e_tpu", {}), ("rav1e_tpu_torch",
                                        {"device": "cpu"})):
        IF = importlib.import_module(pkg + ".models.intra_frame")
        M = importlib.import_module(pkg + ".parallel.mesh")
        fe = IF.IntraFrameEncoder(256, 192, q_idx=140, device_modes=True,
                                  tile_cols_log2=1, tile_rows_log2=1, **kw)
        fe.wavefront_mesh = (M.make_mesh(2, kw["device"]) if kw
                             else M.make_mesh(2))
        out[pkg] = fe.encode([y.astype(np.int32), u.astype(np.int32),
                              v.astype(np.int32)]) + (fe,)
        if pkg == "rav1e_tpu_torch":
            assert fe.stats.key_routes == {"host": 1}
            assert isinstance(ttiles.launch_sharded(fe, fe._tile_grid(),
                                                    fe.wavefront_mesh),
                              ttiles.ShardedLaunch)
    (jt, jr, _), (tt_, tr, _) = out["rav1e_tpu"], out["rav1e_tpu_torch"]
    assert tt_ == jt
    for p in range(3):
        assert np.array_equal(np.asarray(tr[p]), np.asarray(jr[p])), p
