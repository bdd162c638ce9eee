"""Streaming encoder API — the library surface of the framework.

The analogue of the reference C API (reference: Source/API/EbApi.h,
EbInitHandle / EbH265EncSetParameter / EbInitEncoder :*, steady state
EbH265EncSendPicture -> EbH265GetPacket, EbEncHandle.c:3603): pictures go
in without blocking on the encode, coded packets come out in decode order
with pts/dts, and the pipeline runs ahead asynchronously (the reference's
picture-level pipelining via process threads; here one worker thread
driving the staged JAX pipeline, since the heavy stages are device dispatches
that already overlap with host work).

Usage:
    h = EncoderHandle(EncoderConfig(width=..., height=...))
    header = h.stream_header()
    for f in frames:
        h.send_picture(f)
    h.send_eos()
    while (pkt := h.get_packet()) is not None:
        out.write(pkt.data)
    h.close()
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

from .config import EncoderConfig
from .io.yuv import Frame
from .pipeline.encoder import Encoder


@dataclass
class Packet:
    """One coded access unit (reference EB_BUFFERHEADERTYPE analogue)."""

    data: bytes               # Annex-B bytes of the AU (slices + SEIs)
    pts: int                  # presentation index (input order)
    dts: int                  # decode index (emission order)
    slice_type: int           # 2 I, 1 P, 0 B
    is_idr: bool
    recon: Frame | None = None


class EncoderHandle:
    """Asynchronous encode channel: send_picture() enqueues without
    waiting for the encode; get_packet() dequeues coded AUs. Multiple
    handles may run concurrently (the reference's multi-channel mode,
    Source/App multi-instance)."""

    def __init__(self, cfg: EncoderConfig, *, rd: bool | None = None,
                 input_depth: int = 48, return_recon: bool = False):
        self.cfg = cfg.validate()
        self._enc = Encoder(cfg)
        self._rd = rd
        self._recon = return_recon
        self._in: queue.Queue = queue.Queue(maxsize=input_depth)
        self._out: queue.Queue = queue.Queue()
        self._err: BaseException | None = None
        self._err_code = None
        self._on_error = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._eos_sent = False

    # ------------------------------------------------------------- inputs
    def stream_header(self) -> bytes:
        """VPS/SPS/PPS (+ metadata SEI) bytes (EbH265EncStreamHeader)."""
        return self._enc.headers()

    def send_picture(self, frame: Frame) -> None:
        """Enqueue one picture (EbH265EncSendPicture). Blocks only when
        the input queue is full (reference: blocking EbGetEmptyObject).
        Oversized planes are rejected with an INPUT_FORMAT error code
        (the reference validates buffer dims the same way)."""
        from .errors import EncoderError, ErrorCode
        if frame.y is None or frame.y.shape[0] > self.cfg.height + 63 \
                or frame.y.shape[1] > self.cfg.width + 63:
            raise EncoderError(ErrorCode.INPUT_FORMAT,
                               "frame planes do not match configured "
                               f"dimensions {self.cfg.width}x"
                               f"{self.cfg.height}", "api")
        if self._eos_sent:
            raise RuntimeError("send_picture after EOS")
        self._raise_pending()
        self._in.put(frame)

    def send_eos(self) -> None:
        """Mark end of stream (the reference's EOS buffer flag)."""
        if not self._eos_sent:
            self._eos_sent = True
            self._in.put(None)

    # ------------------------------------------------------------ outputs
    def get_packet(self, timeout: float | None = None) -> Packet | None:
        """Next coded AU in decode order; None once the stream is done
        (EbH265GetPacket). Blocks until a packet (or EOS) is available."""
        self._raise_pending()
        item = self._out.get(timeout=timeout)
        if isinstance(item, BaseException):
            raise item
        return item

    def packets(self):
        """Iterate all packets until EOS."""
        while (pkt := self.get_packet()) is not None:
            yield pkt

    def close(self) -> None:
        self.send_eos()
        self._worker.join(timeout=600)

    # ------------------------------------------------------------- worker
    def _frames(self):
        while (fr := self._in.get()) is not None:
            yield fr

    def _run(self) -> None:
        try:
            for au in self._enc.encode_pictures(self._frames(), rd=self._rd):
                self._out.put(Packet(
                    data=au.data, pts=au.display_idx, dts=au.decode_idx,
                    slice_type=au.slice_type, is_idr=au.is_idr,
                    recon=au.recon if self._recon else None))
            self._out.put(None)
        except BaseException as e:              # surface in the caller
            from .errors import classify
            self._err = e
            self._err_code = classify(e)
            if self._on_error is not None:
                # app-level error callback (reference analogue: the
                # error-type reporting path, EbErrorHandling.h:15)
                try:
                    self._on_error(self._err_code, e)
                except Exception:
                    pass
            self._out.put(e)

    def _raise_pending(self) -> None:
        if self._err is not None:
            raise self._err

    @property
    def error_code(self):
        """ErrorCode of a failed encode (errors.ErrorCode.OK if none) —
        the reference's EB_ERRORTYPE query surface."""
        from .errors import ErrorCode
        return self._err_code if self._err is not None else ErrorCode.OK

    def set_error_callback(self, fn) -> None:
        """Register fn(code: ErrorCode, exc) called from the worker when
        the pipeline fails."""
        self._on_error = fn
