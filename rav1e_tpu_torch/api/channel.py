"""Channel API: a frame-sender / packet-receiver pair over a worker
thread, decoupling the producer from the encoder.

Reference analog: src/api/channel/{mod,data}.rs (crossbeam-channel based
FrameSender/PacketReceiver created by Config::new_channel(), used by the
rav1e-ch binary).  Copy of rav1e_tpu/api/channel.py; the encoder runs
on the Config's device.
"""

from __future__ import annotations

import queue
import threading

from rav1e_tpu_torch.api.context import EncoderError, EncoderStatus


class FrameSender:
    def __init__(self, q: queue.Queue):
        self._q = q
        self._closed = False

    def send(self, frame) -> None:
        if self._closed:
            raise RuntimeError("sender closed")
        self._q.put(frame)

    def close(self) -> None:
        """Signal end of stream (the flush)."""
        if not self._closed:
            self._closed = True
            self._q.put(None)


class PacketReceiver:
    def __init__(self, q: queue.Queue, worker: threading.Thread):
        self._q = q
        self._worker = worker

    def recv(self):
        """Next packet, or None at end of stream."""
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def __iter__(self):
        while True:
            p = self.recv()
            if p is None:
                self._worker.join()
                return
            yield p


def new_channel(config):
    """(FrameSender, PacketReceiver) for the given Config; the encoder
    runs on a dedicated worker thread."""
    ctx = config.new_context()
    fq: queue.Queue = queue.Queue(maxsize=32)
    pq: queue.Queue = queue.Queue()

    def drain():
        while True:
            try:
                pq.put(ctx.receive_packet())
            except EncoderError as e:
                if e.status in (EncoderStatus.NEED_MORE_DATA,
                                EncoderStatus.LIMIT_REACHED):
                    return e.status
                raise

    def worker():
        try:
            while True:
                f = fq.get()
                if f is None:
                    ctx.flush()
                    drain()
                    pq.put(None)
                    return
                try:
                    ctx.send_frame(f)
                except EncoderError as e:
                    if e.status != EncoderStatus.ENOUGH_DATA:
                        raise
                    drain()  # backpressure: make progress, then retry
                    ctx.send_frame(f)
                drain()
        except Exception as e:  # surface worker failures to the receiver
            pq.put(e)

    t = threading.Thread(target=worker, name="rav1e-tpu-torch-encoder", daemon=True)
    t.start()
    return FrameSender(fq), PacketReceiver(pq, t)
