"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one source in `csrc/` with a plain C entry point.  It is
compiled with `nvcc` for sm_90a into its own shared library in the port's
build directory (gitignored) and bound with ctypes: pointers and the CUDA
stream as `c_void_p`, and every entry returns `cudaGetLastError()`, which
`check` turns into an exception.  `build_all` starts one `nvcc` per source
at once and waits for all of them.

`COUNTS` holds one launch counter per kernel.  A wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its path went
through the kernels.

Every wrapper launches through `launch`, which makes the device of the
tensors it was given the CUDA runtime's current device for the launch
(entering a device guard only where it is not current already): a
kernel starts on the current device, so with the shards of a mesh on
several GPUs (parallel/mesh.py) a launch on another GPU's tensors would
otherwise fail or run on the wrong card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("intra_pred", "fwd_txq", "inv_txfm", "deblock", "cdef_dir",
           "cdef_filter", "wiener_solve", "wiener_lr", "mc_pred", "me_fullpel",
           "cfl")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# one counter per kernel, "fwd_txq_thin" for fwd_txq's launches with the
# level-1 thinning of the inter race, "wiener_lr_frame" for wiener_lr's
# launches in frame mode (the whole restored plane, no unit choice) and
# "me_fullpel_frame" for me_fullpel's launches from the host inter path's
# frame_me_map; "frame_rd_maps" counts that route's calls on the card
# (each launches intra_pred and fwd_txq twice, at n = 32 and 16), and
# "wavefront_tiles" the key frames whose pass ran on the card over their
# tile columns (parallel/tiles.py; K1-K3 and K11 launch inside it)
COUNTS = {k: 0 for k in KERNELS + ("fwd_txq_thin", "wiener_lr_frame",
                                   "me_fullpel_frame", "frame_rd_maps",
                                   "wavefront_tiles")}
# nvcc's output of the last build of each kernel (ptxas: registers, spills)
BUILD_LOGS: dict = {}
_LIBS: dict = {}

_vp = ctypes.c_void_p
_ci = ctypes.c_int
_cf = ctypes.c_float
ARGTYPES = {
    "intra_pred": [_vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _vp, _vp, _vp, _vp],
    "fwd_txq": [_vp, _ci, _ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci,
                _ci, _ci, _cf, _cf, _vp, _vp, _vp, _vp, _vp, _vp],
    "inv_txfm": [_vp, _vp, _ci, _ci, _ci, _vp, _ci, _ci, _ci, _ci, _vp],
    "deblock_pass": [_vp, _vp, _ci, _ci, _ci, _ci, _vp, _vp, _vp, _ci, _ci,
                     _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _vp],
    "cdef_dir": [_vp, _ci, _ci, _ci, _ci, _vp, _vp, _vp],
    "cdef_filter": [_vp, _vp, _vp, _ci, _ci, _vp, _vp, _vp, _ci, _ci, _ci,
                    _ci, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _vp, _vp, _vp,
                    _vp, _vp, _vp],
    "wiener_solve": [_vp, _vp, _ci, _ci, _ci, _ci] * 3 + [_ci, _vp, _vp, _vp,
                                                          _vp],
    "wiener_lr": [_vp, _ci, _vp, _ci, _vp, _ci, _ci, _ci, _ci, _ci, _vp, _vp,
                  _cf, _cf, _vp, _vp, _vp],
    "mc_pred": [_vp, _ci, _ci, _ci, _ci, _vp, _vp, _vp, _vp, _ci, _ci, _ci,
                _ci, _ci, _vp, _vp, _vp],
    "me_fullpel": [_vp, _ci, _vp, _ci, _ci, _ci, _ci, _vp, _vp, _vp],
    "cfl": [_vp, _ci, _ci, _vp, _vp, _ci, _vp, _vp, _vp, _vp],
}
_ENTRY = {"intra_pred": "intra_pred", "fwd_txq": "fwd_txq",
          "inv_txfm": "inv_txfm", "deblock": "deblock_pass",
          "cdef_dir": "cdef_dir", "cdef_filter": "cdef_filter",
          "wiener_solve": "wiener_solve", "wiener_lr": "wiener_lr",
          "mc_pred": "mc_pred", "me_fullpel": "me_fullpel", "cfl": "cfl"}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _so(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = _so(name)
    return (not so.exists()
            or so.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build_all(names=KERNELS, force: bool = False) -> dict:
    """Compile the named kernels (all stale ones, or all with force) with
    one concurrent nvcc each.  Returns {name: seconds} of the builds run."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        p = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp,
                              str(CSRC / f"{name}.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        procs.append((name, tmp, p))
    secs = {}
    errors = []
    for name, tmp, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        secs[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if p.returncode != 0:
            errors.append(f"{name}.cu:\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, _so(name))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return secs


def lib(name: str):
    """The loaded ctypes library of kernel `name` (built on first use)."""
    L = _LIBS.get(name)
    if L is None:
        if _stale(name):
            build_all([name])
        L = ctypes.CDLL(str(_so(name)))
        fn = getattr(L, _ENTRY[name])
        fn.argtypes = ARGTYPES[_ENTRY[name]]
        fn.restype = ctypes.c_int
        _LIBS[name] = L
    return L


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def launch(name: str, on, *args, count: str | None = None) -> None:
    """Launch kernel `name` on `args` and the current stream of tensor
    `on`'s device, with that device current, and count it under `count`
    (`name` by default).  The device guard is entered only when `on` lies
    on another device than the current one."""
    import torch

    fn = getattr(lib(name), _ENTRY[name])
    if on.device.index != torch.cuda.current_device():
        with torch.cuda.device(on.device):
            return launch(name, on, *args, count=count)
    COUNTS[count or name] += 1
    check(fn(*args, stream_ptr(on)), count or name)


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
