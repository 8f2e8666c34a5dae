"""The live stream decoder, plain PyTorch and numpy: a mono 16-bit
capture fed in blocks of ``feed`` samples, then ended -> what the stream
must answer, and by which call it must have answered each frame.

  1. what: the frames of :func:`recording.decode_recording` over the
     whole capture (list ``list_size``, the sync stride of the
     configuration), since a stream that has seen every sample answers
     as a decoder of the whole recording does, for any split into
     feeds;
  2. when: a frame whose header decoded is due at the call that brings
     the last sample its payload reads, p0 + frame_samples - g + g // 2
     - 1 (the payload window runs g // 2 samples past the frame's last
     symbol, as the recording's windows do): feed k brings samples
     [k * feed, (k + 1) * feed), and the call after the last feed (the
     end of the stream) is number ceil(T / feed).  A live decoder
     (decode.cc:294-301, reading a pipe sample by sample) holds no frame
     back past that call; a frame whose header failed has no due call.

Departures from a decoder of the recording: none in what is answered
where every frame's windows lie inside the capture (the traffic keeps a
gap after the last frame); a live decoder reports a frame whose windows
run past the end of the stream as "past recording end" instead of
decoding it against silence, which this reference does not model.
TF32 is the caller's to keep off.
"""

from __future__ import annotations

import numpy as np

from . import modem as M
from .frontend import identity
from .recording import decode_recording


def due_call(pos: int, mode: int, rate: int, n_samples: int,
             feed: int) -> int:
    """The index of the call by which a frame at ``pos`` of ``mode`` must
    have been emitted: the feed that brings its payload's last sample,
    or the end-of-stream call past the last feed."""
    cfg = M.Config(rate, M.MODES[mode], 0)
    g = cfg.guard_len
    last = pos + cfg.frame_samples - g + g // 2 - 1
    calls = -(-n_samples // feed)
    return min(last // feed, calls)


def decode_stream(pcm: np.ndarray, rate: int, feed: int, list_size: int,
                  sync_stride: int, device, q=identity) -> list:
    """Mono int16 samples [T] fed ``feed`` at a time -> the frames of
    :func:`recording.decode_recording`, each with ``due``: the call by
    which it must have been emitted (None where its header failed)."""
    frames = decode_recording(pcm, rate, list_size, sync_stride, device, q)
    for f in frames:
        f["due"] = (None if f["mode"] is None else
                    due_call(f["pos"], f["mode"], rate, len(pcm), feed))
    return frames
