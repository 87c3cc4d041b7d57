#!/usr/bin/env python3
"""The speed-5 wavefront pass of one 1920x1080 key frame on one NVIDIA GPU,
in fresh processes: its serialised time and its CFL arm's device
operations.

    python3 tools/pass_spread.py [--procs 3] [--reps 3] [ROOT ...]

For each ROOT (a checkout of this repository; the repository itself by
default), in turn and PROCS times over, a fresh Python process imports
ROOT's rav1e_tpu_torch (and this repository's chip_smoke.py), builds the
kernels, encodes one bench frame at SpeedSettings.from_preset(5) through
chip_smoke.encode, counts with torch.profiler the device operations of
the largest call of the wavefront's CFL arm and of the leaf chroma around
it (chip_smoke.cfl_arm), then relaunches the frame's pass alone REPS
times (chip_smoke.serial_pass: a synchronize at each end; the records
must equal the encode's).  Each process prints one JSON line.  Pass the
roots in turns (parent, change, change, parent) to compare two trees on
one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

ONE = """
import importlib.util, json, sys, time
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import torch
from rav1e_tpu_torch import kernels
from rav1e_tpu_torch.utils.content import make_frames
kernels.build_all()
card = cs.card_line()
arm = cs.ArmCapture()
t0 = time.perf_counter()
try:
    _d, _r, fes = cs.encode(make_frames(cs.W, cs.H, 1), check=True, speed=5)
    torch.cuda.synchronize()
finally:
    arm.restore()
first = time.perf_counter() - t0
ops = cs.cfl_arm(arm, card)
passes = [cs.serial_pass(fes[0], card)["serial_pass_s"] for _ in range({reps})]
print(json.dumps({{"pass_spread": {{
    "root": {root!r}, "first_encode_s": first, "serial_pass_s": passes,
    "arm_device_ops": ops["arm"]["device_ops"],
    "chroma_device_ops": ops["chroma"]["device_ops"],
    "arm_host_ms": ops["arm"]["host_ms"],
    "arm_device_ms": ops["arm"]["device_ms"], "card": card}}}}))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--procs", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    roots = [str(Path(r).resolve()) for r in args.roots] or [str(HERE)]
    rc = 0
    for _ in range(args.procs):
        for root in roots:
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-c", ONE.format(
                    root=root, smoke=str(HERE / "chip_smoke.py"),
                    reps=args.reps)],
                cwd=root, capture_output=True, text=True)
            lines = [ln for ln in p.stdout.splitlines()
                     if ln.startswith('{"pass_spread"')]
            if p.returncode or not lines:
                print(p.stderr[-2000:], file=sys.stderr)
                rc = 1
                continue
            out = json.loads(lines[-1])
            out["pass_spread"]["process_s"] = time.perf_counter() - t0
            print(json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
