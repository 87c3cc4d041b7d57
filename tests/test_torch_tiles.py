"""Multi-tile encodes of the port against the JAX package, on the CPU.

The four configurations of tests/test_tiles.py (two tile columns; 2x2
tiles; a 3-frame GOP with tile columns; 2x2 tiles over partial
superblocks) run through Config -> Context of both packages without
`threads`: a single-device tiled encode.  All four are under 320x240, so
both packages code them on the host walk (no wavefront pass, no device
filter chain) and need no substitution: the port's packets and recon
equal the JAX package's, and its stream decodes with libdav1d, through
the port's oracle, to its recon.

Then the tile route of tests/test_multichip.py: an IntraFrameEncoder with
`device_modes=True` and a mesh, no filters, whose tile columns run as one
pass over their stacked lanes (parallel/tiles.py).  At 512x128 with 8
tile columns of one superblock and at 256x128 with 2 columns (at speed 6,
and at speed 5 with CFL in the pass) the port,
given the JAX fdct (the port's own may round an fp32 tie the other way),
writes the JAX package's sharded bytes and recon; with its own fdct it
writes the bytes of its own single-device pass, and decodes to its recon.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1e_tpu.ops import transforms_jax as tj
from rav1e_tpu_torch.ops import transforms as tt
from rav1e_tpu_torch.utils import dav1d_oracle as dav1d
from tests.test_inter_conformance import moving_content, static_content
from tests.test_multichip import content

# one intra-op thread: the suite runs several test processes side by
# side on the CPU
torch.set_num_threads(1)

# (frames, quantizer, tile_cols, tile_rows): tests/test_tiles.py's cases
TILED = {
    "two_col_intra": (lambda: static_content(256, 128, 1, seed=2), 100, 2, 1),
    "2x2_intra": (lambda: static_content(256, 192, 1, seed=4), 140, 2, 2),
    "inter": (lambda: moving_content(256, 128, 3, dx=4, dy=2), 120, 2, 1),
    "partial_sb": (lambda: moving_content(200, 136, 2, dx=2, dy=2), 150, 2,
                   2),
}


def _context_encode(pkg, frames, q, tile_cols, tile_rows, **cfg_kw):
    """Config(enc=EncoderConfig(...)) of tests/test_tiles.py in `pkg`:
    (packet bytes, recon of every shown frame in display order)."""
    C = importlib.import_module(pkg + ".api.config")
    X = importlib.import_module(pkg + ".api.context")
    Fr = importlib.import_module(pkg + ".utils.frame")
    h, w = frames[0][0].shape
    cfg = C.Config(enc=C.EncoderConfig(width=w, height=h, quantizer=q,
                                       tile_cols=tile_cols,
                                       tile_rows=tile_rows), **cfg_kw)
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
    shown = [p.input_frameno for p in pkts if p.shows]
    return ([p.data for p in pkts],
            [ctx._encoder.recon_by_input[no] for no in shown])


def _decodes_to(data, recon):
    dec = dav1d.decode_stream(data)
    assert len(dec) == len(recon)
    for f, r in enumerate(recon):
        for p in range(3):
            rp = np.asarray(r[p])
            assert np.array_equal(dec[f][p][: rp.shape[0], : rp.shape[1]],
                                  rp.astype(np.uint8)), (f, p)


def _same_recon(a, b):
    assert len(a) == len(b)
    for f, (ra, rb) in enumerate(zip(a, b)):
        for p in range(3):
            assert np.array_equal(np.asarray(ra[p]), np.asarray(rb[p])), (f, p)


@pytest.mark.parametrize("case", sorted(TILED))
def test_tiled_encode_matches_jax(case):
    """A single-device tiled encode: the JAX package's packets and
    recon, and a stream that decodes to the recon."""
    make, q, cols, rows = TILED[case]
    frames = make()
    jdata, jrecon = _context_encode("rav1e_tpu", frames, q, cols, rows)
    data, recon = _context_encode("rav1e_tpu_torch", frames, q, cols, rows,
                                  device="cpu")
    assert len(data) == len(jdata)
    for i, (mine, theirs) in enumerate(zip(data, jdata)):
        assert mine == theirs, i
    _same_recon(recon, jrecon)
    _decodes_to(data, recon)


# -- the tile route at the IntraFrameEncoder (tests/test_multichip.py) ---------

_fdct_jit = jax.jit(tj.fdct_batch)


def _jax_fdct(resid, Fv, FhT):
    """The JAX package's fdct_batch, as a drop-in for tt.fdct_plain."""
    return torch.from_numpy(np.array(_fdct_jit(
        jnp.asarray(resid.numpy()), jnp.asarray(Fv.numpy()),
        jnp.asarray(FhT.numpy()))))


def _frame_encode(pkg, w, h, q, log2, mesh_n=None, speed=6):
    """tests/test_multichip.py's encode: (tile bytes, recon, encoder)."""
    IF = importlib.import_module(pkg + ".models.intra_frame")
    M = importlib.import_module(pkg + ".parallel.mesh")
    C = importlib.import_module(pkg + ".api.config")
    kw = {"device": "cpu"} if pkg == "rav1e_tpu_torch" else {}
    y, u, v = content(w, h, 11)
    fe = IF.IntraFrameEncoder(
        w, h, q_idx=q, device_modes=True, tile_cols_log2=log2, speed=speed,
        speed_settings=C.SpeedSettings.from_preset(speed), **kw)
    if mesh_n is not None:
        fe.wavefront_mesh = M.make_mesh(mesh_n, **kw)
    tile, recon = fe.encode([y.astype(np.int32), u.astype(np.int32),
                             v.astype(np.int32)])
    return tile, recon, fe


def _obu_stream(w, h, q, log2, tile):
    from rav1e_tpu_torch.obu.headers import (FrameParams, Sequence,
                                             temporal_delimiter,
                                             write_frame_obu,
                                             write_sequence_header_obu)

    seq = Sequence(width=w, height=h)
    fp = FrameParams(base_q_idx=q, disable_cdf_update=False,
                     tile_cols_log2=log2)
    return (temporal_delimiter() + write_sequence_header_obu(seq)
            + write_frame_obu(seq, fp, tile))


@pytest.mark.parametrize("w,h,q,log2,speed", [(512, 128, 110, 3, 6),
                                              (256, 128, 130, 1, 6),
                                              (256, 128, 130, 1, 5)])
def test_tile_route_matches_jax_sharded(w, h, q, log2, speed, monkeypatch):
    """The tile route on the CPU against the JAX sharded route on the
    virtual mesh of as many devices as tile columns (at speed 5 with CFL
    in the pass): the same bytes and recon given the JAX fdct; with its
    own fdct the port's tile route writes the bytes of its own
    single-device pass, and they decode."""
    from rav1e_tpu_torch.models import wavefront as twf

    n = 1 << log2
    jtile, jrecon, _ = _frame_encode("rav1e_tpu", w, h, q, log2, n, speed)
    flags = []
    with monkeypatch.context() as m:
        m.setattr(tt, "fdct_plain", _jax_fdct)
        orig = twf._pass_flags
        m.setattr(twf, "_pass_flags",
                  lambda fe: flags.append(orig(fe)) or flags[-1])
        tile, recon, fe = _frame_encode("rav1e_tpu_torch", w, h, q, log2, n,
                                        speed)
    assert fe.stats.key_routes == {"tiles": 1}
    assert [f[1] for f in flags] == [speed <= 5]  # CFL in the pass
    assert tile == jtile
    _same_recon([recon], [jrecon])
    own, own_recon, _ = _frame_encode("rav1e_tpu_torch", w, h, q, log2, n,
                                      speed)
    single, single_recon, fs = _frame_encode("rav1e_tpu_torch", w, h, q,
                                             log2, speed=speed)
    assert fs.stats.key_routes == {"single": 1}
    assert own == single
    _same_recon([own_recon], [single_recon])
    _decodes_to([_obu_stream(w, h, q, log2, own)], [own_recon])
