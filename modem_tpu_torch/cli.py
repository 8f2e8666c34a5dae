"""Reference-compatible command line, on the port.

Counterpart of ``modem_tpu/cli.py`` with the same argv, return codes,
stderr texts and output files; the reference binaries' argv
(encode.cc:340, decode.cc:562):

  python3 -m modem_tpu_torch.cli encode OUTPUT RATE BITS CHANNELS OFFSET \\
      MODE CALLSIGN INPUT..
  python3 -m modem_tpu_torch.cli decode OUTPUT INPUT [SKIP]

'-' means stdin / stdout for the data files, as in the reference
(encode.cc:345-346,408-409; decode.cc:570-574).  Beyond the reference
binaries: ``decode-all [--adaptive] PREFIX INPUT`` decodes every frame
of a recording (``pipeline.decode_recording_auto``), ``decode-stream
PREFIX [INPUT]`` decodes a WAV stream as it arrives (``stream.
StreamDecoder``; the reference's ``arecord -f S16_LE | decode``
workflow), ``freezer`` prints the polar tables (freezer.cc:34-39), and
``multipath``, ``cfo``, ``sfo`` and ``awgn`` apply the impairments of
the demonstration's chain (README.md:42-49; ``channel``).

The work runs on the card; :func:`main` takes ``device="cpu"`` for the
plain versions.  Only an unsupported sample rate is caught (as the
reference reports it); a failed kernel build or launch raises.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from . import bits as B
from . import wav
from .numerology import DATA_BYTES, MAX_CALL_SIGN, make_config

USAGE = ("usage: modem_tpu_torch.cli {encode|decode|decode-all|"
         "decode-stream|freezer|multipath|cfo|sfo|awgn} ...")


def _read_input(name: str, single: bool) -> bytes:
    # '-' is stdin only for a single input file (encode.cc:408-409:
    # `argc == 9 && input_name[0] == '-'`); with several it is a name
    if name == "-" and single:
        data = sys.stdin.buffer.read(DATA_BYTES)
    else:
        try:
            f = open(name, "rb")
        except OSError:
            # the reference's open check tests ifstream::bad(), which a
            # failed open does not set (encode.cc:410-413): it prints
            # nothing and encodes a payload of 0xFF bytes
            return b"\xff" * DATA_BYTES
        with f:
            data = f.read(DATA_BYTES)
    return data.ljust(DATA_BYTES, b"\xff")  # ifstream.get() past EOF


def cmd_encode(argv: list[str], device) -> int:
    if len(argv) < 8:
        print("usage: encode OUTPUT RATE BITS CHANNELS OFFSET MODE "
              "CALLSIGN INPUT..", file=sys.stderr)
        return 1
    output_name, rate, out_bits, channels = (
        argv[0], int(argv[1]), int(argv[2]), int(argv[3]))
    freq_off, oper_mode, call_str = int(argv[4]), int(argv[5]), argv[6]
    inputs = argv[7:]

    if out_bits not in (8, 16):
        print("Unsupported bits per sample.", file=sys.stderr)
        return 1
    if channels not in (1, 2):
        print("Only real or analytic signal (one or two channels) "
              "supported.", file=sys.stderr)
        return 1
    if oper_mode < 6 or oper_mode > 13:
        print("Unsupported operation mode.", file=sys.stderr)
        return 1
    call_sign = B.base37_encode(call_str)
    if call_sign <= 0 or call_sign >= MAX_CALL_SIGN:
        print("Unsupported call sign.", file=sys.stderr)
        return 1
    try:
        cfg = make_config(rate, oper_mode, freq_off, channels)
    except ValueError as e:
        print(f"{e}.".replace("..", "."), file=sys.stderr)
        return 1

    from .encoder import cached_encoder
    payloads = [_read_input(name, len(inputs) == 1) for name in inputs]
    wave_c, papr = cached_encoder(cfg, device).encode(payloads, call_sign)

    def db(x):
        return 10.0 * np.log10(x)

    valid = papr[:, 0] > 0
    print(f"real PAPR: {db(papr[valid, 0].min()):.4g} .. "
          f"{db(papr[valid, 0].max()):.4g} dB", file=sys.stderr)
    if channels == 2:
        validq = papr[:, 1] > 0
        print(f"imag PAPR: {db(papr[validq, 1].min()):.4g} .. "
              f"{db(papr[validq, 1].max()):.4g} dB", file=sys.stderr)

    silence = np.zeros(rate, dtype=np.complex64)
    full = np.concatenate([silence, wave_c, silence])
    if output_name == "-":
        output_name = "/dev/stdout"
    wav.write_wav(output_name, full, rate, out_bits, channels)
    return 0


def cmd_decode(argv: list[str], device) -> int:
    if len(argv) < 2 or len(argv) > 3:
        print("usage: decode OUTPUT INPUT [SKIP]", file=sys.stderr)
        return 1
    output_name, input_name = argv[0], argv[1]
    skip = int(argv[2]) if len(argv) > 2 else 0
    if input_name == "-":
        input_name = "/dev/stdin"

    data = wav.read_wav(input_name)
    if data.channels < 1 or data.channels > 2:
        print("Only real or analytic signal (one or two channels) "
              "supported.", file=sys.stderr)
        return 1
    from .decoder import cached_decoder
    try:
        dec = cached_decoder(data.rate, device=device)
    except ValueError:
        print("Unsupported sample rate.", file=sys.stderr)
        return 1

    samples = (data.samples[:, 0] if data.channels == 1
               else data.samples[:, :2])
    # the decoder writes the reference's stderr transcript itself
    # (decode.cc:400-555)
    res = dec.decode(samples, channels=data.channels, skip=skip,
                     log=sys.stderr)
    if not res.ok:
        if not res.status_emitted:
            print(res.status, file=sys.stderr)
        return 1
    if output_name == "-":
        output_name = "/dev/stdout"
    try:
        f = open(output_name, "wb")
    except OSError:
        print(f'Couldn\'t open file "{output_name}" for writing.',
              file=sys.stderr)               # decode.cc:609-611
        return 1
    with f:
        f.write(res.payload)
    return 0


def cmd_decode_all(argv: list[str], device) -> int:
    """decode-all [--adaptive] OUTPUT_PREFIX INPUT: every frame of a
    recording, each with its own mode and call sign, one batch a mode;
    ``--adaptive`` decodes with SC first and the list decoder on CRC
    failures (the same results on anything either decodes)."""
    adaptive = False
    if argv and argv[0] == "--adaptive":
        adaptive = True
        argv = argv[1:]
    if len(argv) != 2:
        print("usage: decode-all [--adaptive] OUTPUT_PREFIX INPUT",
              file=sys.stderr)
        return 1
    prefix, input_name = argv
    if input_name == "-":
        input_name = "/dev/stdin"
    from .pipeline import decode_recording_auto
    # int16 / uint8 WAV files stay in wire dtype, with the front end on
    # the device; pipes and other formats go through the float reader
    pcm = wav.read_wav_raw(input_name)
    if pcm is not None:
        frames = decode_recording_auto(pcm, pcm.rate, channels=pcm.channels,
                                       adaptive=adaptive, device=device)
    else:
        data = wav.read_wav(input_name)
        if data.channels < 1 or data.channels > 2:
            print("Only real or analytic signal (one or two channels) "
                  "supported.", file=sys.stderr)
            return 1
        samples = (data.samples[:, 0] if data.channels == 1
                   else data.samples[:, :2])
        frames = decode_recording_auto(samples, data.rate,
                                       channels=data.channels,
                                       adaptive=adaptive, device=device)
    if not frames:
        print("no frames found", file=sys.stderr)
        return 1
    bad = 0
    for i, f in enumerate(frames):
        bad += _emit_frame(prefix, i, f)
    return 1 if bad else 0


def _emit_frame(prefix: str, i: int, f: dict) -> int:
    """Report one decoded frame on stderr (the reference's rejection
    texts, decode.cc:417-446) and write its payload file; returns 1 if
    the frame failed."""
    if f["mode"] is None:
        print(f"frame {i}: pos {f['pos']} header rejected: "
              f"{f['status']}", file=sys.stderr)
        return 1
    print(f"frame {i}: pos {f['pos']} mode {f['mode']} "
          f"call sign {f['call_sign']} "
          f"{'ok' if f['ok'] else 'FAILED'} flips {f['flips']}",
          file=sys.stderr)
    if not f["ok"]:
        return 1
    with open(f"{prefix}.{i:03d}", "wb") as out:
        out.write(f["payload"])
    return 0


def _read_exact(f, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        got = f.read(n - len(buf))
        if not got:
            break
        buf += got
    return buf


def cmd_decode_stream(argv: list[str], device) -> int:
    """decode-stream OUTPUT_PREFIX [INPUT]: live decoding of a WAV
    stream (stdin by default).  Each frame's payload file is written as
    soon as its last payload sample has been read, not at EOF; frames
    print to stderr as in decode-all."""
    if len(argv) < 1 or len(argv) > 2:
        print("usage: decode-stream OUTPUT_PREFIX [INPUT]",
              file=sys.stderr)
        return 1
    prefix = argv[0]
    input_name = argv[1] if len(argv) > 1 else "-"
    if input_name == "-":
        return _decode_stream(prefix, sys.stdin.buffer, device)
    with open(input_name, "rb") as f:
        return _decode_stream(prefix, f, device)


def _decode_stream(prefix: str, f, device) -> int:
    # incremental RIFF parse (wav.hh: PCM 8/16-bit LE, 1-2 channels)
    head = _read_exact(f, 12)
    if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        print("not a WAV stream", file=sys.stderr)
        return 1
    channels = rate = bits = audio_fmt = None
    while True:
        hdr = _read_exact(f, 8)
        if len(hdr) < 8:
            print("no data chunk in WAV stream", file=sys.stderr)
            return 1
        cid = hdr[:4]
        size = int.from_bytes(hdr[4:8], "little")
        if cid == b"fmt ":
            fmt = _read_exact(f, size)
            audio_fmt = int.from_bytes(fmt[0:2], "little")
            channels = int.from_bytes(fmt[2:4], "little")
            rate = int.from_bytes(fmt[4:8], "little")
            bits = int.from_bytes(fmt[14:16], "little")
        elif cid == b"data":
            data_left = size
            break
        else:
            _read_exact(f, size)
        if size % 2:            # RIFF chunks pad to even offsets
            _read_exact(f, 1)
    if audio_fmt != 1 or bits not in (8, 16):
        print("Only 8/16-bit integer PCM supported.", file=sys.stderr)
        return 1
    if channels not in (1, 2):
        print("Only real or analytic signal (one or two channels) "
              "supported.", file=sys.stderr)
        return 1
    from .stream import StreamDecoder
    try:
        sd = StreamDecoder(rate, channels=channels, bits=bits, device=device)
    except ValueError:
        print("Unsupported sample rate.", file=sys.stderr)
        return 1

    dt = np.dtype("<i2") if bits == 16 else np.dtype(np.uint8)
    block = channels * dt.itemsize
    n_done = 0
    bad = 0

    def emit(frames):
        nonlocal n_done, bad
        for fr in frames:
            bad += _emit_frame(prefix, n_done, fr)
            n_done += 1

    # the declared data size keeps trailing RIFF chunks (LIST / INFO) out
    # of the PCM; 0 and 0xFFFFFFFF are a stream's "size unknown": to EOF
    if data_left in (0, 0xFFFFFFFF):
        data_left = None
    # a pipe is read 1 s a feed (the source paces it), a file 16 s
    try:
        seekable = f.seekable()
    except (AttributeError, OSError, ValueError):
        seekable = False
    feed_seconds = 16 if seekable else 1
    rem = b""
    while data_left is None or data_left > 0:
        want = rate * block * feed_seconds
        if data_left is not None:
            want = min(want, data_left)
        got = f.read(want)
        if data_left is not None:
            data_left -= len(got)
        raw = rem + got
        if not raw:
            break
        keep = len(raw) - len(raw) % block
        rem = raw[keep:]
        if not keep:
            break
        flat = np.frombuffer(raw[:keep], dtype=dt)
        emit(sd.feed(flat if channels == 1 else flat.reshape(-1, 2)))
    emit(sd.finish())
    if n_done == 0:
        print("no frames found", file=sys.stderr)
        return 1
    return 1 if bad else 0


def _impair_read(input_name: str):
    """A WAV for the impairment tools: (WavData, complex samples)."""
    if input_name == "-":
        input_name = "/dev/stdin"
    data = wav.read_wav(input_name)
    if data.channels == 2:
        x = (data.samples[:, 0] + 1j * data.samples[:, 1]).astype(
            np.complex128)
    else:
        x = data.samples[:, 0].astype(np.complex128)
    return data, x


def _impair_write(output_name: str, data, y: np.ndarray) -> int:
    if output_name == "-":
        output_name = "/dev/stdout"
    wav.write_wav(output_name, y.astype(np.complex64), data.rate,
                  data.bits, data.channels)
    return 0


def _parse_taps(path):
    """Tap profile file: one `delay gain_re [gain_im]` a line (the
    demonstration's file-driven taps, README.md:49); '-' or none is
    ``channel.DEFAULT_MULTIPATH``."""
    from . import channel
    if path in (None, "-"):
        return channel.DEFAULT_MULTIPATH
    taps = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            im = float(parts[2]) if len(parts) > 2 else 0.0
            taps.append((int(parts[0]), float(parts[1]) + 1j * im))
    if not taps:
        raise SystemExit("empty tap profile")
    return tuple(taps)


def cmd_multipath(argv: list[str]) -> int:
    """multipath OUTPUT INPUT [TAPS [FACTOR]]: complex FIR at (delay x
    FACTOR)-sample offsets (`multipath - - <taps> 10`, README.md:42-49)."""
    if len(argv) < 2 or len(argv) > 4:
        print("usage: multipath OUTPUT INPUT [TAPS [FACTOR]]",
              file=sys.stderr)
        return 1
    from . import channel
    taps = _parse_taps(argv[2] if len(argv) > 2 else None)
    factor = int(argv[3]) if len(argv) > 3 else 1
    data, x = _impair_read(argv[1])
    return _impair_write(argv[0], data,
                         channel.multipath(x, taps, spread=factor))


def cmd_cfo(argv: list[str]) -> int:
    """cfo OUTPUT INPUT FREQ: carrier frequency offset in Hz (`cfo - -
    234.567`, README.md:49)."""
    if len(argv) != 3:
        print("usage: cfo OUTPUT INPUT FREQ", file=sys.stderr)
        return 1
    from . import channel
    data, x = _impair_read(argv[1])
    if data.channels == 1:
        # a real passband signal shifts through its analytic signal
        # (shifting the real samples would mirror the spectrum)
        x = channel.analytic_np(x.real)
    y = channel.cfo(x, float(argv[2]), data.rate)
    if data.channels == 1:
        y = y.real.astype(np.complex128)
    return _impair_write(argv[0], data, y)


def cmd_sfo(argv: list[str]) -> int:
    """sfo OUTPUT INPUT PPM: sample-clock offset by windowed-sinc
    resampling (`sfo - - 147`, README.md:49)."""
    if len(argv) != 3:
        print("usage: sfo OUTPUT INPUT PPM", file=sys.stderr)
        return 1
    from . import channel
    data, x = _impair_read(argv[1])
    return _impair_write(argv[0], data, channel.sfo(x, float(argv[2])))


def cmd_awgn(argv: list[str]) -> int:
    """awgn OUTPUT INPUT DB [SEED]: white Gaussian noise at DB relative to
    full scale (`awgn - - -30`, README.md:49)."""
    if len(argv) < 3 or len(argv) > 4:
        print("usage: awgn OUTPUT INPUT DB [SEED]", file=sys.stderr)
        return 1
    from . import channel
    rng = np.random.default_rng(int(argv[3]) if len(argv) > 3 else 0)
    data, x = _impair_read(argv[1])
    if data.channels == 1:
        # real noise at the stated total power
        sigma = 10.0 ** (float(argv[2]) / 20.0)
        y = (x.real + sigma * rng.standard_normal(len(x))).astype(
            np.complex128)
    else:
        y = channel.awgn(x, float(argv[2]), rng)
    return _impair_write(argv[0], data, y)


def cmd_freezer(argv: list[str]) -> int:
    """Print the polar frozen-bit tables (freezer.cc:34-39)."""
    from .fec.freezer import frozen_mask, mask_to_words
    for n, k in ((64512, 43072), (64800, 43072)):
        erasure = (n - k) / n
        design = 10 * math.log10(-math.log(erasure))
        print(f"design SNR: {design}", file=sys.stderr)
        print(f"better SNR: {design + 1.59175}", file=sys.stderr)
        words = mask_to_words(frozen_mask(n, k, 16))
        body = ", ".join(f"0x{w:x}" for w in words)
        print(f"static const uint32_t frozen_{n}_{k}[{len(words)}] = "
              f"{{ {body}, }};")
    return 0


def main(argv=None, device="cuda") -> int:
    """Run one command; returns its exit code.  ``device``: where the
    encoder and the decoders run (the card unless told otherwise)."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(USAGE, file=sys.stderr)
        return 1
    cmd, rest = argv[0], argv[1:]
    on_device = {"encode": cmd_encode, "decode": cmd_decode,
                 "decode-all": cmd_decode_all,
                 "decode-stream": cmd_decode_stream}
    on_host = {"freezer": cmd_freezer, "multipath": cmd_multipath,
               "cfo": cmd_cfo, "sfo": cmd_sfo, "awgn": cmd_awgn}
    if cmd in on_device:
        return on_device[cmd](rest, str(device))
    if cmd in on_host:
        return on_host[cmd](rest)
    print(f"unknown command {cmd}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
