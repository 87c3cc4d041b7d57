"""rav1e-tpu-torch: the rav1e-tpu AV1 encoder ported to PyTorch and CUDA.

The JAX package `rav1e_tpu` beside it is the reference this port is held
against.  The port imports `torch` and nothing of JAX or `rav1e_tpu`; it
keeps its own copies of the host modules it needs.

- device compute: PyTorch glue over hand-written CUDA kernels for Hopper
  (csrc/: intra prediction, forward transform + quantiser, inverse
  transform, deblock, CDEF directions and filter, Wiener tap solve and
  filter), each with a plain PyTorch version that runs when the tensors
  lie on the CPU;
- host native path: the C++ MSAC entropy coder + block coder
  (native/*.cc, built by ec/native.py into the port's build directory);
- orchestration: Config / Context / FrameEncoder as in the JAX package.

Ported so far: key frames at the speed-6 defaults (CDEF search and apply,
fused Wiener loop restoration) and with either filter off.  Inter frames,
the speed <= 5 filter searches (SGR, the deblock level search) and
multi-GPU sharding raise NotImplementedError.

Layout:
  api/      Config / Context / EncoderStatus public API
  obu/      OBU headers, bit writers, IVF muxing (host)
  ec/       MSAC range coder (C++ + python reference impl)
  entropy/  CDF tables, symbol contexts, coefficient tokenization
  ops/      intra, transforms, deblock, cdef, lrf and the filter chain
            (device)
  models/   encode pipelines (wavefront pass, band maps, frame encoders)
  utils/    frames, stats, the libdav1d conformance oracle
  csrc/     CUDA sources of the kernels
"""

__version__ = "0.1.0"

from rav1e_tpu_torch.api.config import Config, EncoderConfig, SpeedSettings  # noqa: F401
from rav1e_tpu_torch.api.context import Context, EncoderStatus, Packet  # noqa: F401
