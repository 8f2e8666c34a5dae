"""Live decoding: feed PCM as it arrives, emit each frame as soon as its
last payload sample has been received.

Counterpart of ``modem_tpu/stream.py``.  The reference decodes live
audio one sample at a time from a pipe (decode.cc:294-301; the README's
``arecord -f S16_LE | decode`` workflow).  :class:`StreamDecoder` walks
the same chunked scan as ``sync.Synchronizer.scan`` over the samples
received so far, one chunk as soon as its metric window is buffered,
with the Schmitt state and the running argmax carried across ``feed()``
calls; then, once the windows they read are buffered:

* the fine stage and the gates of each sync event;
* the BCH + OSD headers, one ``Decoder.decode_headers_batch`` a feed;
* the payloads, grouped by (mode, convention), through the cached
  list-8 ``BatchPipeline`` of each group (kernel B): the step
  ``pipeline.cut_groups`` / ``decode_groups`` that
  ``pipeline.decode_recording_auto`` also takes.

The samples live in an ``ingest.StreamBuffer`` on the host in wire
dtype (or as a complex analytic signal for float input).  Every window,
a scan chunk's included, is cut there at absolute positions and copied
to the device alone, where mono PCM runs the dequantise, DC block and
Hilbert front end with the DC count clamped at the absolute stream
start; so the bytes copied a feed grow with the feed, and the samples
of a window do not depend on what has been retired.  The buffer retires
behind a watermark that protects the oldest pending frame's windows.

While ``torch.profiler`` records, each ``feed`` and ``finish`` is a
request span (``stream.feed`` / ``stream.finish``) holding
``stream.scan`` (the chunk walk), ``stream.fine`` (the fine stage),
``stream.headers`` and ``stream.payload``; each window's copy to the
device is a ``profiling.upload``, so ``profiling.syncs`` counts it.

Inputs: integer PCM (int16 / uint8; mono [n], or stereo [n, 2] I/Q) or
float analytic ([n, 2] I/Q or complex [n]).  Float mono raises
``ValueError``: quantise it to int16, the wire format.

On a complete stream the emitted frames equal ``decode_recording_auto``
on the same recording, for any split into feeds.  A frame whose header
or payload window runs past the true stream end is reported "past
recording end" and never decoded against the silence pad (the reference
stops at a failed read, decode.cc:296-297).
"""

from __future__ import annotations

import numpy as np

from . import bits as B
from .ingest import StreamBuffer
from .numerology import MODES, ModemConfig
from .pipeline import cached_pipeline, cut_groups, decode_groups, rejected
from .profiling import span
from .sync import _BLK


class StreamDecoder:
    """Incremental decoder of one PCM stream (one rate and layout) on
    ``device``::

        sd = StreamDecoder(8000, channels=1, bits=16)
        for block in source:               # numpy int16 [n]
            for frame in sd.feed(block):
                ...                        # decode_recording_auto's dicts
        for frame in sd.finish():
            ...

    ``bits``: 16 or 8 for integer PCM, None for float analytic input.
    ``chunk_samples``: the scan's chunk (rounded up to 512-sample
    blocks); ``mls_convention`` as for ``Decoder``."""

    # falling edges kept a scan chunk: twice the density decode-all allows
    # (4 * 64 a 2^17-sample chunk), so noise edges cannot take the slots
    # of a real preamble any earlier than they would there
    EDGES_PER_CHUNK = 32

    def __init__(self, rate: int, channels: int = 2, bits=16,
                 chunk_samples: int = 8192, mls_convention: str = "galois",
                 device="cuda"):
        from .decoder import cached_decoder
        self.rate = rate
        self.device = str(device)
        self.dec = cached_decoder(rate, mls_convention=mls_convention,
                                  device=self.device)
        self.sync = self.dec.sync
        self.cfg = self.sync.cfg
        self.L = self.sync.L
        if bits is None and channels == 1:
            raise ValueError("float mono streaming is unsupported; feed "
                             "int16 wire PCM (the device front end)")
        if channels not in (1, 2):
            raise ValueError(f"{channels} channels: want 1 or 2")
        self.channels = channels
        self.bits = bits
        self.buf = StreamBuffer(bits, 1 if bits is None else channels)
        self.c, self.ctx = self.sync._context(chunk_samples)
        # raw samples a window reads ahead of its first output
        self.lead = self.sync.front_lead if bits and channels == 1 else 0
        self.chunks = 0                 # scan chunks walked
        self.peak_buffered = 0          # most samples held after a feed
        self._carry = self.sync.scan_start()
        self._events = []               # (p0, frac_cfo) awaiting the fine stage
        self._cands = []                # gated SyncCandidates awaiting headers
        # (p0, mode, call, convention) awaiting payloads
        self._frames = []
        self._eos = None                # the stream's length, once finished

    # -- input -------------------------------------------------------------

    def _norm(self, samples) -> np.ndarray:
        x = np.asarray(samples)
        if self.bits is None:
            if np.iscomplexobj(x) and x.ndim == 1:
                return x.astype(np.complex64)
            if x.ndim != 2 or x.shape[1] != 2 or np.iscomplexobj(x):
                raise ValueError("float stream must be [n, 2] or complex")
            out = np.empty(len(x), np.complex64)
            out.real = x[:, 0]
            out.imag = x[:, 1]
            return out
        want = np.int16 if self.bits == 16 else np.uint8
        if x.dtype != want:
            raise ValueError(f"bits={self.bits} stream needs {want.__name__}")
        if self.channels == 1 and x.ndim != 1:
            raise ValueError("mono stream must be [n]")
        if self.channels == 2 and (x.ndim != 2 or x.shape[1] != 2):
            raise ValueError("stereo stream must be [n, 2]")
        return x

    # -- stages ------------------------------------------------------------

    def _scan_chunk(self) -> None:
        """The next scan chunk: its events, and the carries."""
        got, self._carry = self.sync.chunk_step(
            self.buf, self.chunks * self.c, self.c, self.ctx, self._carry,
            self.buf.end - 2 * self.L, self.EDGES_PER_CHUNK)
        self.chunks += 1
        self._events.extend(self.sync.assemble_events(got))

    def _finalize_events(self) -> None:
        """Fine stage and gates (decode.cc:110-146) of every event whose
        window [p0 + L, p0 + 2L) is buffered."""
        done = self._eos is not None
        ready, wait = [], []
        for e in self._events:
            (ready if done or e[0] + 2 * self.L <= self.buf.end
             else wait).append(e)
        self._events = wait
        if not ready:
            return
        wins = self.sync.windows(self.buf, [p + self.L for p, _ in ready],
                                 self.L)
        self._cands.extend(c for c in self.sync.fine_candidates(wins, ready)
                           if c.ok)

    def _header_stage(self, emitted: list) -> None:
        s, g = self.cfg.symbol_len, self.cfg.guard_len

        def hdr_end(c):
            # every convention hypothesis's window must be buffered: under
            # "auto" their p0 differ, and gating on the best-ranked alone
            # could find a later true hypothesis past the end mid-stream
            return max([p for _k, p, _cf, _r in c.alts] or [c.p0]) + 2 * s + g

        if self._eos is None:
            ready = [c for c in self._cands if hdr_end(c) <= self.buf.end]
            self._cands = [c for c in self._cands
                           if hdr_end(c) > self.buf.end]
        else:
            ready, self._cands = self._cands, []
            # a header window past the true end is not decoded against
            # the silence pad (decode.cc:296-297)
            for c in ready:
                if c.p0 + 2 * s + g > self._eos:
                    emitted.append(rejected(c.p0, "past recording end"))
            ready = [c for c in ready if c.p0 + 2 * s + g <= self._eos]
        if not ready:
            return
        for c, (hdr, status) in zip(
                ready, self.dec.decode_headers_batch(self.buf, ready)):
            if hdr is None:
                emitted.append(rejected(c.p0, status))
            else:
                mode, call = hdr
                self._frames.append((c.p0, mode,
                                     B.base37_decode(call).lstrip(),
                                     self.sync.conventions[c.conv]))

    def _payload_stage(self, emitted: list) -> None:
        g = self.cfg.guard_len
        ready, rest = [], []
        for f in self._frames:
            p0, mode, call, _conv = f
            fsamp = ModemConfig(rate=self.rate, mode=MODES[mode],
                                freq_off=0).frame_samples
            end = p0 + fsamp - g     # windows_at reads through end + g // 2
            if self._eos is not None and end > self._eos:
                emitted.append(rejected(p0, "past recording end", mode,
                                        call))
            elif self._eos is not None or end + g // 2 <= self.buf.end:
                ready.append(f)
            else:
                rest.append(f)
        self._frames = rest
        emitted.extend(decode_groups(cut_groups(
            self.buf, ready, cached_pipeline, self.rate, self.device)))

    def _retire(self) -> None:
        """Drop the samples no pending stage can read: a future event's p0
        lies at most L + g + match_del + 1 behind the next chunk, the next
        chunk reads ctx before it, and a pending p0's windows (a header's
        hypothesis up to g / 2 earlier, the payload window's lead 2s + g)
        reach 2s + 2g before it; mono windows read ``lead`` raw samples
        ahead of that."""
        s, g = self.cfg.symbol_len, self.cfg.guard_len
        n0 = self.chunks * self.c
        pend = [n0 - (self.L + g + self.sync.match_del + 1)]
        pend += [p for p, _ in self._events]
        for c in self._cands:
            pend += [p for _k, p, _cf, _r in c.alts] or [c.p0]
        pend += [f[0] for f in self._frames]
        low = min(min(pend) - (2 * s + 2 * g) - _BLK, n0 - self.ctx)
        self.buf.retire(low - self.lead)

    def _stages(self) -> list:
        emitted: list = []
        with span("stream.fine"):
            self._finalize_events()
        with span("stream.headers"):
            self._header_stage(emitted)
        with span("stream.payload"):
            self._payload_stage(emitted)
        emitted.sort(key=lambda f: f["pos"])
        return emitted

    # -- public ------------------------------------------------------------

    def feed(self, samples) -> list:
        """Append stream samples; returns the frames they completed, as
        dicts with ``decode_recording_auto``'s keys {pos, mode,
        call_sign, ok, payload, flips, snr, status}, in time order."""
        if self._eos is not None:
            raise RuntimeError("stream already finished")
        with span("stream.feed"):
            self.buf.append(self._norm(samples))
            self.peak_buffered = max(self.peak_buffered,
                                     self.buf.data.shape[0])
            with span("stream.scan"):
                while (self.chunks + 1) * self.c + 2 * self.L <= self.buf.end:
                    self._scan_chunk()
            emitted = self._stages()
            self._retire()
        return emitted

    def finish(self) -> list:
        """End of stream: walk the last chunks with silence past the end,
        complete every pending stage, and return the remaining frames."""
        if self._eos is not None:
            return []
        with span("stream.finish"):
            self._eos = self.buf.end
            with span("stream.scan"):
                while self.chunks * self.c < self._eos - 2 * self.L:
                    self._scan_chunk()
            return self._stages()
