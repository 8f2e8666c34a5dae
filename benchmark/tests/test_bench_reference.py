"""The reference's frozen copies and the input makers, at small sizes on
the CPU.  The program is imported here only to show that the copies
still say what the wire format says."""

import numpy as np
import pytest
import torch

from harness import inputs
from reference import channel as C
from reference import modem as M
from reference.decode import decode_batch
from reference.frontend import FrontEnd, to_bf16
from reference.polar import crc_select, sc_decode, scl_decode
from reference.roofline import decoder_bound
from toycell import TOY_CONFIG, toy_params

TOY = M.config_of(TOY_CONFIG["modem"])


@pytest.mark.parametrize("mode", [6, 12])
def test_frozen_set_schedule_and_crc_equal_the_wire_formats(mode):
    from modem_tpu_torch import bits as PB
    from modem_tpu_torch.fec.freezer import frozen_mask
    from modem_tpu_torch.fec.schedule import build_schedule
    md = M.MODES[mode]
    code = M.Code(md)
    want = frozen_mask(md.cons_bits, md.crc_bits, 16)
    assert np.array_equal(code.frozen, want)
    sched = build_schedule(want.tobytes())
    assert np.array_equal(code.schedule.ops, sched.ops[:, :13])
    assert code.schedule.out_off == sched.out_off
    assert np.array_equal(M.crc_matrix(M.CRC32_POLY, 32, 300),
                          PB.crc32.check_matrix(300))
    assert np.array_equal(M.mls_bits(M.MLS1_POLY, 255),
                          PB.mls_bits(M.MLS1_POLY, 255))


def test_roofline_counts_at_the_cells_shapes():
    sched = M.Code(M.MODES[6]).schedule
    a = decoder_bound(sched, 512, 1)
    b = decoder_bound(sched, 16, 8)
    assert a["bytes"] == 512 * (4 * 65536 + 65536 + 4)
    assert a["bound_by"] == "bytes" and b["bound_by"] == "operations"
    # per frame and lane: F 4, G 2, COMBINE 1 and leaves 2 an element
    w, k = sched.ops[:, M.C_WIDTH], sched.ops[:, M.C_OP]
    lane = (4 * w[k == M.OP_F].sum() + 2 * w[k == M.OP_G].sum()
            + w[k == M.OP_COMBINE].sum() + 2 * w[k >= M.OP_RATE0].sum())
    assert a["operations"] == 512 * lane
    assert b["operations"] > 16 * 8 * lane


def test_the_encoder_and_the_reference_receiver_agree_at_a_toy_size():
    gen = torch.Generator().manual_seed(5)
    params = toy_params()
    bits = inputs.payload_bits(TOY.mode.data_bytes, 4, gen, "cpu")
    recs = inputs.recordings(TOY, params, bits, np.arange(4) * 1000, gen)
    res = decode_batch(FrontEnd(TOY, "cpu"), recs, 8)
    assert res["ok"].all()
    assert np.array_equal(res["bits"], bits.numpy())
    assert (res["flips"] == 0).all() and res["sync_gate"].all()
    pad = int(params["pad_s"] * TOY.rate)
    lead = TOY.extended_len + TOY.guard_len   # pilot, S&C guard
    assert (abs(res["p0"] - (pad + lead)) <= 1).all()


def test_the_program_decodes_the_inputs_as_the_reference_does():
    from modem_tpu_torch.numerology import toy_mode
    from modem_tpu_torch.pipeline import AdaptivePipeline
    gen = torch.Generator().manual_seed(9)
    params = toy_params(-5.0)
    bits = inputs.payload_bits(TOY.mode.data_bytes, 8, gen, "cpu")
    recs = inputs.recordings(TOY, params, bits, np.arange(8), gen)
    ref = decode_batch(FrontEnd(TOY, "cpu"), recs, 8)
    pipe = AdaptivePipeline(8000, 0, mode_spec=toy_mode(
        **TOY_CONFIG["modem"]["mode"]), symbol_len_override=256,
        device="cpu")
    got = pipe.decode_batch(recs)
    assert not ref["ok"].all()             # the noise escalates some
    for k in ("ok", "p0", "sync_gate", "flips"):
        assert np.array_equal(got[k], ref[k]), k
    assert np.array_equal(got["bits"][ref["ok"]], ref["bits"][ref["ok"]])
    assert np.abs(got["snr"] - ref["snr"]).max() < 1e-3


def test_list_decoding_finds_what_sc_misses():
    code = M.Code(TOY.mode)
    gen = torch.Generator().manual_seed(3)
    params = toy_params(-4.0)
    bits = inputs.payload_bits(TOY.mode.data_bytes, 16, gen, "cpu")
    recs = inputs.recordings(TOY, params, bits, np.arange(16), gen)
    llrs = FrontEnd(TOY, "cpu")(recs)["llrs"]
    ok1, _ = crc_select(*sc_decode(llrs, code.schedule), code)
    ok8, b8 = crc_select(*scl_decode(llrs, code.schedule, 8), code)
    assert ok8.sum() > ok1.sum()
    assert torch.equal(b8[ok8], bits[ok8])


def test_the_channel_chain_equals_the_wire_tools():
    from modem_tpu_torch import channel as PC
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(3000) + 1j * rng.standard_normal(3000)) * 0.1
    want = PC.sfo(PC.cfo(PC.multipath(x, spread=10), 234.567, 8000), 147.0)
    got = C.sfo(C.cfo(C.multipath(torch.as_tensor(x)[None], 10), 234.567,
                      8000), 147.0)[0].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-9
    gen = torch.Generator().manual_seed(1)
    noisy = C.awgn(torch.zeros(1, 200000, dtype=torch.complex128), -18.0,
                   gen)
    power = float((noisy.abs() ** 2).mean())
    assert power == pytest.approx(10 ** (-1.8), rel=0.02)


def test_bf16_rounding_keeps_dtype_and_loses_precision():
    x = torch.tensor([1.0 + 1e-3, 3.0], dtype=torch.float32)
    y = to_bf16(x)
    assert y.dtype == x.dtype and y[0] == 1.0 and y[1] == 3.0
    z = to_bf16(torch.complex(x, x))
    assert z.dtype == torch.complex64 and z[0].imag == 1.0
