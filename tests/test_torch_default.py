"""The port's default configuration against the JAX package, on the CPU.

The workload is what `EncoderConfig()` gives, quantizer 100 and an
8-frame lookahead: low_latency=False, speed 6, multiref.  Frames come in
pyramid sub-GOPs of 4: the sub-GOP's ALTREF first (LAST only, on the
inter wavefront at 320x240), then its inner frames with LAST, LAST2,
GOLDEN, BWDREF and ALTREF references on the host inter path: one ME map
a reference (frame_me_map, K10's plain version here), the interpolation
filter probe, single-reference and compound candidates, the merge and
partition trials, the host walk, the host filter path (the deblock, the
device CDEF search and apply, the loop-restoration decision with K8's
frame mode).  The hidden ALTREFs come back as show_existing_frame
packets.

The JAX package runs once per size, in a module fixture.  As in
tests/test_torch_inter.py the port takes the JAX fdct and the JAX
chain's Wiener taps on the wavefront frames (its own round an fp32 tie
the other way at times); the host frames are numpy in both packages and
need no substitution.  Under 320x240 nothing runs a wavefront: no ME map
(the diamond search), the host key path, and no substitution at all.
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
from rav1e_tpu_torch.utils.content import make_planes

# one intra-op thread: the suite runs several test processes side by
# side on the CPU, and torch's default (a thread a core in each) makes
# them contend
torch.set_num_threads(1)

SEED = 20261017
W, H, NF = 320, 240, 9  # 1 key + two sub-GOPs of 4
SW, SH, SNF = 192, 128, 5  # under 320x240: 1 key + one sub-GOP of 4
# the per-frame fields both packages must agree on
FIELDS = ("wf_inter", "ref_ids", "reference_select", "comp_block_count",
          "interp_filter", "lr_types")


def _encode(pkg: str, w: int, h: int, nf: int, chains=None, **cfg_kw):
    """Encode nf frames of the bench content at EncoderConfig()'s
    defaults.  Returns (packet bytes, per-inter-frame FIELDS in coding
    order, recon planes per input frame).  With `chains` (the JAX
    package), every filter chain's (taps, en, the CDEF output they were
    solved for)."""
    C = importlib.import_module(pkg + ".api.config")
    X = importlib.import_module(pkg + ".api.context")
    Fr = importlib.import_module(pkg + ".utils.frame")
    IF = importlib.import_module(pkg + ".models.inter_frame")
    cfg = C.Config(enc=C.EncoderConfig(width=w, height=h, quantizer=100,
                                       rdo_lookahead_frames=8), **cfg_kw)
    info = []
    undo = []
    orig_f = IF.InterFrameEncoder._finish_encode

    def fspy(fe):
        out = orig_f(fe)
        info.append({k: getattr(fe, k) for k in FIELDS})
        info[-1]["lr_types"] = list(info[-1]["lr_types"])
        return out

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

        for y, u, v in make_planes(w, h, nf):
            ctx.send_frame(Fr.Frame.from_planes(y, u, v))
            drain()
        ctx.flush()
        drain()
    finally:
        for owner, name, orig in undo:
            setattr(owner, name, orig)
    recon = [ctx._encoder.recon_by_input[i] for i in range(nf)]
    return [p.data for p in pkts], info, recon


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


def _decodes_to(data, recon):
    dec = dav1d.decode_stream(data)
    assert len(dec) == len(recon)
    for f, r in enumerate(recon):
        for p in range(3):
            rp = np.asarray(r[p])
            assert np.array_equal(dec[f][p][: rp.shape[0], : rp.shape[1]],
                                  rp.astype(np.uint8)), (f, p)


@pytest.fixture(scope="module")
def jax_gop():
    chains = []
    data, info, recon = _encode("rav1e_tpu", W, H, NF, chains=chains)
    return data, info, recon, chains


@pytest.fixture(scope="module")
def jax_small_gop():
    return _encode("rav1e_tpu", SW, SH, SNF)


# -- frame_me_map: K10 over an edge-padded reference ----------------------------------


@pytest.mark.parametrize("kind", ["flat", "noisy"])
def test_frame_me_map_matches_jax(kind):
    """frame_me_map at 320x256 against the JAX package's, the reference a
    real-size 320x240 plane edge-padded to the source's shape as
    _compute_me_maps pads it: flat content (the padded rows and every
    offset tie, the first minimum wins) and noisy content shifted by a
    known motion.  Identical MVs, in 1/8 pel."""
    from rav1e_tpu.models.device_pipeline import frame_me_map as jmap
    from rav1e_tpu_torch.models.device_pipeline import frame_me_map

    rng = np.random.default_rng(SEED + len(kind))
    h, w, rh = 256, 320, 240
    base = rng.integers(0, 256, (h + 64, w + 64))
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    src = base[32 : 32 + h, 32 : 32 + w].astype(np.int32)
    if kind == "flat":
        ref = np.full((rh, w), 90, np.int32)
        ref[:, 200:] = 91
    else:
        ref = np.clip(base[32 - 3 : 32 - 3 + rh, 32 + 6 : 32 + 6 + w]
                      + rng.integers(-4, 5, (rh, w)), 0, 255).astype(np.int32)
    pad = np.zeros_like(src)
    pad[:rh] = ref
    pad[rh:] = pad[rh - 1 : rh]
    want = np.asarray(jmap(src, pad, 32))
    got = frame_me_map(src, pad, 32, device="cpu")
    assert got.dtype == np.int32 and got.shape == (h // 32, w // 32, 2)
    assert np.array_equal(got, want)
    if kind == "noisy":  # the known motion, in most blocks above the pad
        assert (got[:-1] == (8 * 3, -8 * 6)).all(-1).mean() > 0.85


def test_frame_me_map_high_bit_depth_and_bad_planes():
    """K10 searches 10-bit planes too: a 10-bit frame_me_map on the CPU is
    me_fullpel_plain's map in 1/8 pel.  Planes of two shapes, a shape that
    is not 64-aligned, or samples outside 0..(1 << bit_depth) - 1 raise
    ValueError."""
    from rav1e_tpu_torch.models.device_pipeline import (frame_me_map,
                                                        me_fullpel_plain)

    rng = np.random.default_rng(SEED + 10)
    src = rng.integers(0, 1024, (64, 128)).astype(np.int32)
    ref = np.roll(src, (2, -5), (0, 1))
    got = frame_me_map(src, ref, 32, bit_depth=10, device="cpu")
    want = me_fullpel_plain(torch.from_numpy(src), torch.from_numpy(ref),
                            32).numpy() * 8
    assert got.dtype == np.int32 and np.array_equal(got, want)
    a = np.zeros((64, 128), np.int32)
    with pytest.raises(ValueError, match="64-aligned"):
        frame_me_map(a, a[:, :64], 32, device="cpu")
    with pytest.raises(ValueError, match="64-aligned"):
        frame_me_map(a[:48], a[:48], 32, device="cpu")
    with pytest.raises(ValueError, match="0..255"):
        frame_me_map(a, a + 256, 32, device="cpu")
    with pytest.raises(ValueError, match="0..1023"):
        frame_me_map(a, a + 1024, 32, bit_depth=10, device="cpu")


# -- the compound mode context ----------------------------------------------------------

# every (NewMvContext, RefMvContext) find_mv_stack can give, and the spec's
# Compound_Mode_Ctx_Map[RefMvContext >> 1][Min(NewMvContext, 4)]
SPEC_COMP_CTX = {(0, 0): 0, (1, 1): 1, (1, 2): 2, (2, 3): 3, (3, 3): 4,
                 (2, 4): 5, (3, 4): 6, (4, 5): 7, (5, 5): 7}


@pytest.mark.parametrize("cell", sorted(SPEC_COMP_CTX))
def test_comp_mode_ctx_is_the_spec_table(cell):
    """The inter_compound_mode context is the spec's table on every
    reachable cell.  The JAX package's fitted formula agrees but at (1, 2)
    (no close match, two far ones), where libdav1d misreads its streams:
    the port's 640x480 default-config GOP of bench content (9 frames)
    hits that cell in its second sub-GOP, and its stream decodes to its
    recon only with the table."""
    from rav1e_tpu.models.inter_frame import comp_mode_cdf_ctx as jctx
    from rav1e_tpu_torch.models.inter_frame import comp_mode_cdf_ctx

    assert comp_mode_cdf_ctx(*cell) == SPEC_COMP_CTX[cell]
    assert (jctx(*cell) == SPEC_COMP_CTX[cell]) == (cell != (1, 2))


def test_extra_search_takes_both_lists_of_a_compound_neighbor():
    """The single-reference extra search takes both MVs of a compound
    neighbor, so the stack can reach 3 entries (spec
    add_extra_mv_candidate, libaom process_single_ref_mv_candidate, dav1d
    add_single_extended_candidate); the decoder then reads a DRL bit after
    NEARMV.  The JAX package's find_mv_stack stops at 2, and libdav1d
    refuses the port's own 1080p default-config GOP written that way (its
    fourth packet, a BWDREF NEARMV block under a LAST+ALTREF compound
    block).  Here: a BWDREF block with a BWDREF left neighbor and a
    LAST+ALTREF above neighbor."""
    from rav1e_tpu.models import mv_pred as jmvp
    from rav1e_tpu_torch.models import mv_pred as mvp

    sign_bias = {mvp.LAST_FRAME: 0, mvp.BWDREF_FRAME: 1, mvp.ALTREF_FRAME: 1}
    stacks = []
    for m in (mvp, jmvp):
        grid = m.MiGrid(16, 16)
        grid.set_block(0, 4, 8, 4, m.LAST_FRAME, (164, -130),
                       ref2=m.ALTREF_FRAME, mv2=(-6, -92))
        grid.set_block(4, 0, 4, 8, m.BWDREF_FRAME, (-52, 22))
        stacks.append(m.find_mv_stack(grid, 4, 4, 8, 8, m.BWDREF_FRAME,
                                      tile=(0, 0, 16, 16),
                                      sign_bias=sign_bias))
    mine, jax_ = stacks
    # the left neighbor's MV, then the above one's two lists, the LAST MV
    # sign-flipped (the other temporal side), the ALTREF one as it is
    assert mine.num_mv_found == 3
    assert mine.stack[:3] == [(-52, 22), (-164, 130), (-6, -92)]
    assert jax_.num_mv_found == 2 and jax_.stack[:2] == mine.stack[:2]


# -- the default-config GOP at 320x240 -------------------------------------------------


def test_default_gop_matches_jax(jax_gop, monkeypatch):
    """1 key + 8 inter frames through Config -> Context at the defaults,
    the port with the JAX fdct and the JAX chain's taps: the JAX
    package's packets byte for byte (show_existing_frame ones included),
    the same path, references, reference_select, compound block count,
    interpolation filter and LR types frame by frame, and the same
    recon."""
    from rav1e_tpu_torch.ops import lrf as tlr

    jdata, jinfo, jrecon, chains = jax_gop
    monkeypatch.setattr(tt, "fdct_plain", _jax_fdct)
    monkeypatch.setattr(tlr, "wiener_solve_plain", _jax_taps(chains))
    data, info, recon = _encode("rav1e_tpu_torch", W, H, NF, device="cpu")
    assert info == jinfo
    # the pyramid: the first ALTREF on the inter wavefront, then host
    # frames with references beyond LAST, compound blocks among them
    assert info[0]["wf_inter"] and info[0]["ref_ids"] == [1]
    host = [f for f in info if not f["wf_inter"]]
    assert len(host) == NF - 2
    assert any(f["reference_select"] and f["comp_block_count"] > 0
               for f in host)
    assert any({2, 4} & set(f["ref_ids"]) for f in host)
    # 9 coded frames and 4 show_existing_frame packets (each sub-GOP's
    # hidden ALTREF and BWDREF)
    assert len(data) == len(jdata) == NF + 4
    for i, (mine, theirs) in enumerate(zip(data, jdata)):
        assert mine == theirs, i
    for f in range(NF):
        for p in range(3):
            assert np.array_equal(np.asarray(recon[f][p]),
                                  np.asarray(jrecon[f][p])), (f, p)


def test_default_gop_decodes_to_recon(jax_gop):
    """The port's own default-config stream (its fdct, its tap solve)
    decodes with libdav1d, through the port's oracle, to exactly its
    recon in display order, show_existing_frame packets included; on CPU
    tensors the wrappers ran their plain versions and counted nothing."""
    from rav1e_tpu_torch import kernels

    kernels.reset_counts()
    data, info, recon = _encode("rav1e_tpu_torch", W, H, NF, device="cpu")
    assert [f["ref_ids"] for f in info] == [f["ref_ids"]
                                            for f in jax_gop[1]]
    _decodes_to(data, recon)
    assert not any(kernels.COUNTS.values())


# -- under 320x240: no ME map, the host key path ----------------------------------------


def test_small_gop_matches_jax(jax_small_gop):
    """1 key + 4 inter frames at 192x128: no wavefront and no ME map (the
    host diamond search), the host key path; byte-identical to the JAX
    package with no substitution, the same per-frame fields, and the
    stream decodes to the port's recon."""
    jdata, jinfo, jrecon = jax_small_gop
    data, info, recon = _encode("rav1e_tpu_torch", SW, SH, SNF, device="cpu")
    assert info == jinfo
    assert not any(f["wf_inter"] for f in info)
    assert any(f["comp_block_count"] > 0 for f in info)
    assert data == jdata
    _decodes_to(data, recon)


def test_stream_check_decodes_a_saved_stream(tmp_path, capsys):
    """The check chip_smoke.py's saved default-config stream takes where
    libdav1d is: an IVF of the 192x128 GOP and its recon digests pass;
    one wrong digest fails."""
    import json

    from rav1e_tpu_torch.obu.ivf import write_ivf_frame, write_ivf_header
    from rav1e_tpu_torch.utils import stream_check

    data, _info, recon = _encode("rav1e_tpu_torch", SW, SH, SNF,
                                 device="cpu")
    ivf = tmp_path / "default.ivf"
    with open(ivf, "wb") as fh:
        write_ivf_header(fh, SW, SH, 30, 1, len(data))
        for i, pkt in enumerate(data):
            write_ivf_frame(fh, i, pkt)
    digests = [stream_check.recon_digest(r) for r in recon]
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"recon_sha256": digests}))
    assert stream_check.main(["", str(ivf), str(good)]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"recon_sha256": digests[:-1] + ["0" * 64]}))
    assert stream_check.main(["", str(ivf), str(bad)]) == 1
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[0])["frames_decoded"] == SNF
    assert json.loads(out[1])["decode_equals_recon"] is False
