"""CLI: y4m in -> IVF out (reference analog: src/bin/rav1e.rs).

Usage: python -m rav1e_tpu_torch input.y4m -o output.ivf [--quantizer 100]
           [--speed 6] [--limit N] [--psnr] [--reconstruction recon.y4m]
           [--device cuda|cpu]

The device passes run on the GPU; `--device cpu` asks for the kernels'
plain PyTorch versions on the CPU (Config(device="cpu")).  Without a GPU
and without `--device cpu` the encode stops with an error: it never moves
to the CPU on its own.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from rav1e_tpu_torch.api.config import Config, EncoderConfig
from rav1e_tpu_torch.api.context import EncoderError, EncoderStatus
from rav1e_tpu_torch.obu.ivf import write_ivf_frame, write_ivf_header
from rav1e_tpu_torch.utils.frame import read_y4m, write_y4m_frame, write_y4m_header


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rav1e_tpu_torch",
                                 description="AV1 encoder on PyTorch and CUDA")
    ap.add_argument("input", help="input .y4m file ('-' for stdin)")
    ap.add_argument("-o", "--output", required=True, help="output .ivf file")
    ap.add_argument("--quantizer", type=int, default=100, help="base quantizer 0..255")
    ap.add_argument("-s", "--speed", type=int, default=6, help="speed preset 0..10")
    ap.add_argument("-l", "--limit", type=int, default=0, help="max frames (0 = all)")
    ap.add_argument("--psnr", action="store_true", help="report PSNR of reconstruction")
    ap.add_argument("--metrics", action="store_true", help="report PSNR + SSIM")
    ap.add_argument("--bitrate", type=int, default=0, help="target bitrate (bps); 0 = CQ")
    ap.add_argument("--first-pass", help="write pass-1 stats to FILE")
    ap.add_argument("--second-pass", help="read pass-1 stats from FILE")
    ap.add_argument("--reconstruction", help="write reconstruction to .y4m")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="per-stage timing + block statistics summary")
    ap.add_argument("--shard-dir",
                    help="per-GOP checkpointing: write keyframe-segment "
                         "shards + manifest here, resuming a killed encode "
                         "at the last completed segment (not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the device passes (default cuda; "
                         "cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.shard_dir:
        raise NotImplementedError(
            "--shard-dir needs api/resume.py, which is not ported yet "
            "(ROADMAP queue 1 item 13)")

    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    meta, frames = read_y4m(fin)
    w, h = meta["width"], meta["height"]
    fps = meta["fps"]

    from rav1e_tpu_torch.api.config import SpeedSettings

    cfg = Config(
        enc=EncoderConfig(
            width=w,
            height=h,
            bit_depth=meta["bit_depth"],
            chroma_sampling=meta["ss"],
            quantizer=args.quantizer,
            bitrate=args.bitrate,
            rc_stats=(open(args.second_pass, "rb").read() if args.second_pass else None),
            time_base=(fps[1], fps[0]),
            speed_settings=SpeedSettings.from_preset(args.speed),
        ),
        device=args.device,
    )
    ctx = cfg.new_context()

    fout = open(args.output, "wb")
    write_ivf_header(fout, w, h, fps[0], fps[1])
    frec = None
    if args.reconstruction:
        frec = open(args.reconstruction, "wb")
        write_y4m_header(frec, w, h, fps, meta["bit_depth"], meta["ss"])

    n = 0
    total_bytes = 0
    psnr_acc = []
    ssim_acc = []
    t0 = time.perf_counter()
    src_frames = {}

    def handle(pkt):
        nonlocal total_bytes, n
        write_ivf_frame(fout, pkt.input_frameno, pkt.data)
        total_bytes += len(pkt.data)
        if not pkt.shows:
            return
        n += 1
        recon = ctx._encoder.recon_by_input.get(pkt.input_frameno)
        src = src_frames.pop(pkt.input_frameno, None)
        if recon is None or src is None:
            return
        if args.psnr or args.metrics:
            from rav1e_tpu_torch.utils.metrics import frame_psnr, ssim

            srcs = [pl.window() for pl in src.planes]
            psnr_acc.append(frame_psnr(recon, srcs, meta["bit_depth"])["combined"])
            if args.metrics:
                ssim_acc.append(ssim(recon[0], srcs[0], meta["bit_depth"]))
        if frec is not None:
            from rav1e_tpu_torch.utils.frame import Frame

            write_y4m_frame(frec, Frame.from_planes(*recon, meta["bit_depth"], meta["ss"]))

    def drain():
        while True:
            try:
                handle(ctx.receive_packet())
            except EncoderError as e:
                if e.status in (EncoderStatus.NEED_MORE_DATA,
                                EncoderStatus.LIMIT_REACHED):
                    return
                raise

    sent = 0
    for frame in frames:
        src_frames[sent] = frame
        ctx.send_frame(frame)
        sent += 1
        drain()
        if args.limit and sent >= args.limit:
            break
    ctx.flush()
    drain()
    dt = time.perf_counter() - t0
    if args.first_pass:
        with open(args.first_pass, "wb") as fstats:
            fstats.write(ctx.twopass_summary())
            fstats.write(ctx.twopass_out())
    fout.close()
    if frec:
        frec.close()
    if fin is not sys.stdin.buffer:
        fin.close()

    kbps = total_bytes * 8 * fps[0] / fps[1] / max(n, 1) / 1000
    msg = f"encoded {n} frames, {dt:.2f}s ({n / dt:.2f} fps), {kbps:.1f} kb/s"
    if psnr_acc:
        msg += f", PSNR avg {np.mean(psnr_acc):.2f} dB"
    if ssim_acc:
        msg += f", SSIM(Y) avg {np.mean(ssim_acc):.4f}"
    print(msg, file=sys.stderr)
    if args.verbose:
        print(ctx.stats.summary(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
