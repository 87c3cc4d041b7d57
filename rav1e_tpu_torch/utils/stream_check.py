"""Check a saved stream against its encoder's reconstruction by decoding.

The card's machine has no libdav1d, so `chip_smoke.py --save-stream DIR`
writes its default-configuration stream as DIR/default.ivf and the
SHA-256 of each displayed frame's recon as DIR/default_recon.json (and
likewise its 1080p key-frame stream as DIR/key.ivf and its 10-bit stream
as DIR/hbd.ivf).  On a machine
with libdav1d:

    python -m rav1e_tpu_torch.utils.stream_check DIR/default.ivf \\
        DIR/default_recon.json

decodes the stream (show_existing_frame packets included) and exits 0
when every displayed frame's digest equals the recon's, printing one JSON
line either way.
"""

from __future__ import annotations

import hashlib
import json
import sys

import numpy as np


def recon_digest(planes, bit_depth: int = 8) -> str:
    """SHA-256 of a frame's Y, U, V planes at their sample width, in
    order: uint8 bytes at 8 bits, little-endian uint16 above."""
    dtype = np.uint8 if bit_depth == 8 else np.dtype("<u2")
    h = hashlib.sha256()
    for p in planes:
        a = np.asarray(p)
        if a.min() < 0 or a.max() >= 1 << bit_depth:
            raise ValueError(f"recon_digest: samples outside {bit_depth} "
                             "bits")
        h.update(np.ascontiguousarray(a.astype(dtype)).tobytes())
    return h.hexdigest()


def main(argv) -> int:
    from rav1e_tpu_torch.obu.ivf import read_ivf
    from rav1e_tpu_torch.utils import dav1d_oracle

    ivf, digests = argv[1], argv[2]
    with open(ivf, "rb") as fh:
        packets = [data for _pts, data in read_ivf(fh)]
    with open(digests) as fh:
        rec = json.load(fh)
    want, bd = rec["recon_sha256"], rec.get("bit_depth", 8)
    dec = dav1d_oracle.decode_stream(packets)
    got = [recon_digest(d, bd) for d in dec]
    ok = got == want
    print(json.dumps({"packets": len(packets), "frames_decoded": len(dec),
                      "frames_expected": len(want),
                      "decode_equals_recon": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
