"""rav1e-tpu-torch: the rav1e-tpu AV1 encoder ported to PyTorch and CUDA.

The JAX package `rav1e_tpu` beside it is the reference this port is held
against.  The port imports `torch` and nothing of JAX or `rav1e_tpu`; it
keeps its own copies of the host modules it needs.

- device compute: PyTorch glue over hand-written CUDA kernels for Hopper
  (csrc/: intra prediction, forward transform + quantiser, inverse
  transform, deblock, CDEF directions and filter, Wiener tap solve and
  filter, motion compensation, motion search, chroma-from-luma), each
  with a plain PyTorch version that runs when the tensors lie on the CPU;
- host native path: the C++ MSAC entropy coder + block coder
  (native/*.cc, built by ec/native.py into the port's build directory);
- orchestration: Config / Context / FrameEncoder as in the JAX package.

Ported so far: low-latency encodes (key frames, P frames from LAST) at the
speed-6 defaults (CDEF search and apply, fused Wiener loop restoration),
with either filter off, at speed 5 (CFL in the wavefront pass, the
host deblock level search, the CDEF search outside the device chain, the
SGR and per-unit Wiener loop-restoration search) and at speeds 0-3 (the
8x8 leaves of the wavefront pass, the host RD at 16 and the rectangular
partitions below 320x240); the CLI (`python -m rav1e_tpu_torch in.y4m
-o out.ivf -s 3`, on the card unless `--device cpu`); the default
configuration (low_latency=False: pyramid, multi-reference and compound
frames on the host inter path, its ME maps on the card); 4:2:0 frames of
10 and 12 bits (the host walk over frame_rd_maps, the host inter path on
16-bit planes, CDEF and the Wiener trial filter at the frame's bit
depth); tile-column encodes (Config(threads=N) with tile_cols=N: the key
frames' wavefront pass over their tile columns as one batch on the
Context's device, parallel/tiles.py); the GOP-shard checkpoint/resume
(api/resume.py, the CLI's --shard-dir), the channel API (api/channel.py)
and the C API facade (capi.py).  Lossless coding (quantizer 0) raises NotImplementedError at the
Context: its key frames would lack the 4x4 Walsh-Hadamard transform, as
the JAX package's do, and not decode to the recon (ROADMAP fault F6);
FrameEncoder still codes them as the JAX package does, for the parity
tests.  4:2:2 and 4:4:4 frames encode
through the same host paths (without CDEF, as in the JAX package) but
are not yet held against it (ROADMAP queue 1 item 10b).  With
RAV1E_TPU_LR_FUSE=0 (the JAX package's switch of the same name) the
filter chain runs without its fused loop-restoration stage: the Wiener
taps are solved on the host and each unit's decision runs on the planes
the chain kept on the card (ops/lrf.py lr_decide_device).  The
source-edge analysis functions of the JAX package that no encode path
calls are here too: models/device_pipeline.py mode_analysis,
frame_mode_maps, intra_analysis_step and their sharded forms,
ops/intra.py dr_predict_batch, predict_stack, build_edges_batch and
ops/mc.py put_single_batch.

Layout:
  api/      Config / Context / EncoderStatus public API
  obu/      OBU headers, bit writers, IVF muxing (host)
  ec/       MSAC range coder (C++ + python reference impl)
  entropy/  CDF tables, symbol contexts, coefficient tokenization
  ops/      intra, transforms, deblock, cdef, lrf and the filter chain
            (device)
  models/   encode pipelines (wavefront pass, band maps, frame encoders)
  parallel/ the tile route: tile columns as a batch axis of the pass
  utils/    frames, stats, the libdav1d conformance oracle
  csrc/     CUDA sources of the kernels
"""

__version__ = "0.1.0"

from rav1e_tpu_torch.api.config import Config, EncoderConfig, SpeedSettings  # noqa: F401
from rav1e_tpu_torch.api.context import Context, EncoderStatus, Packet  # noqa: F401
