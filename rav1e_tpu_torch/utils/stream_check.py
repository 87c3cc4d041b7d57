"""Check a saved stream against its encoder's reconstruction by decoding.

The card's machine has no libdav1d, so `chip_smoke.py --save-stream DIR`
writes its default-configuration stream as DIR/default.ivf and the
SHA-256 of each displayed frame's recon as DIR/default_recon.json.  On a
machine with libdav1d:

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


def recon_digest(planes) -> str:
    """SHA-256 of a frame's Y, U, V planes as uint8 bytes, in order."""
    h = hashlib.sha256()
    for p in planes:
        h.update(np.ascontiguousarray(np.asarray(p).astype(np.uint8)).tobytes())
    return h.hexdigest()


def main(argv) -> int:
    from rav1e_tpu_torch.obu.ivf import read_ivf
    from rav1e_tpu_torch.utils import dav1d_oracle

    ivf, digests = argv[1], argv[2]
    with open(ivf, "rb") as fh:
        packets = [data for _pts, data in read_ivf(fh)]
    with open(digests) as fh:
        want = json.load(fh)["recon_sha256"]
    dec = dav1d_oracle.decode_stream(packets)
    got = [recon_digest(d) for d in dec]
    ok = got == want
    print(json.dumps({"packets": len(packets), "frames_decoded": len(dec),
                      "frames_expected": len(want),
                      "decode_equals_recon": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
