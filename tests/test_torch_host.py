"""The port's numpy host modules equal the JAX package's originals:
numerology, bits (CRC, scrambler, MLS, base37), the frozen-set design,
the BCH encoder, the decoder schedule, and the polar transforms."""

import numpy as np
import pytest
import torch

from modem_tpu import bits as jbits
from modem_tpu import numerology as jnum
from modem_tpu.fec import bch as jbch
from modem_tpu.fec import freezer as jfreezer
from modem_tpu.fec import polar as jpolar
from modem_tpu.fec import scl_vm
from modem_tpu.parallel import toy_config as jax_toy_config
from modem_tpu_torch import bits, numerology
from modem_tpu_torch.fec import bch, freezer, polar, schedule


@pytest.mark.parametrize("rate", [8000, 16000, 44100, 48000])
@pytest.mark.parametrize("mode", sorted(numerology.MODES))
def test_numerology_matches(rate, mode):
    a, b = numerology.make_config(rate, mode), jnum.make_config(rate, mode)
    assert a.mode == numerology.MODES[mode]
    for name in ("symbol_len", "guard_len", "extended_len", "offset_bin",
                 "code_off", "mls0_off", "mls1_off", "frame_symbols",
                 "frame_samples", "filter_len", "buffer_len", "search_pos"):
        assert getattr(a, name) == getattr(b, name), name
    assert vars(a.mode) == vars(b.mode)


def test_toy_config_matches():
    a, b = numerology.toy_config(), jax_toy_config()
    assert vars(a.mode) == vars(b.mode)
    assert (a.rate, a.freq_off, a.symbol_len) == (b.rate, b.freq_off,
                                                  b.symbol_len)


def test_config_validation_messages():
    with pytest.raises(ValueError, match="Unsupported sample rate"):
        numerology.make_config(11025, 6)
    with pytest.raises(ValueError, match="divisible by 50"):
        numerology.make_config(8000, 6, freq_off=2010)
    with pytest.raises(ValueError, match="unsupported operation mode"):
        numerology.make_config(8000, 5)


@pytest.mark.parametrize("nbits", [480, 43072])
def test_crc_check_matrix_matches(nbits):
    assert np.array_equal(bits.crc32.check_matrix(nbits),
                          jbits.crc32.check_matrix(nbits))


def test_crc_values_match():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    assert bits.crc32.over_bytes(data) == jbits.crc32.over_bytes(data)
    assert bits.crc16.over_value(123456789 << 9) == \
        jbits.crc16.over_value(123456789 << 9)
    # the check matrix reproduces the byte-wise CRC
    b = bits.bytes_to_bits_le(data)
    reg = (b @ bits.crc32.check_matrix(len(b)).astype(np.int64)) % 2
    assert int(sum(int(v) << i for i, v in enumerate(reg))) == \
        bits.crc32.over_bytes(data)


def test_scramble_and_packing_match():
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
    assert bits.scramble(data) == jbits.scramble(data)
    assert bits.scramble(bits.scramble(data)) == data
    b = bits.bytes_to_bits_le(data)
    assert np.array_equal(b, jbits.bytes_to_bits_le(data))
    assert bits.bits_to_bytes_le(b) == data


@pytest.mark.parametrize("poly,count", [(numerology.MLS0_POLY, 127),
                                        (numerology.MLS1_POLY, 255),
                                        (numerology.MLS2_POLY, 432)])
def test_mls_matches(poly, count):
    assert np.array_equal(bits.mls_nrz(poly, count),
                          jbits.mls_nrz(poly, count, convention="galois"))


def test_mls_other_conventions_wait():
    with pytest.raises(NotImplementedError):
        bits.mls_bits(numerology.MLS0_POLY, 8, convention="msb")


@pytest.mark.parametrize("text", ["N0CALL", "toy", "A B", "a!b", ""])
def test_base37_matches(text):
    assert bits.base37_encode(text) == jbits.base37_encode(text)


@pytest.mark.parametrize("n,k,order", [(224, 144, 8), (960, 480, 10),
                                       (64800, 43072, 16),
                                       (64512, 43072, 16)])
def test_frozen_mask_matches(n, k, order):
    assert np.array_equal(freezer.frozen_mask(n, k, order),
                          jfreezer.frozen_mask(n, k, order))


def test_bch_encode_matches():
    rng = np.random.default_rng(3)
    for _ in range(4):
        d = rng.integers(0, 2, 71, dtype=np.uint8)
        assert np.array_equal(bch.encode(d), jbch.encode(d))


@pytest.mark.parametrize("n,k,order", [(224, 144, 8), (960, 480, 10),
                                       (64800, 43072, 16)])
def test_schedule_matches(n, k, order):
    """The instruction table and buffer geometry equal scl_vm's exactly;
    Schedule.from_table rebuilds the geometry from a table alone."""
    key = freezer.frozen_mask(n, k, order).tobytes()
    a = schedule.build_schedule(key, emit_spc=True)
    b = scl_vm.build_schedule(key, emit_spc=True)
    assert np.array_equal(a.ops, b.ops)
    for name in ("sz_llr", "sz_beta", "n_depths", "code_len", "out_off"):
        assert getattr(a, name) == getattr(b, name), name
    c = schedule.Schedule.from_table(b.ops, 1 << order)
    assert (c.sz_llr, c.sz_beta, c.out_off) == (b.sz_llr, b.sz_beta,
                                                b.out_off)


def test_schedule_constants_match():
    assert schedule.CHUNK == scl_vm.CHUNK
    for name in ("OP_F", "OP_G", "OP_COMBINE", "OP_RATE0", "OP_REP",
                 "OP_RATE1", "OP_SPC", "C_OP", "C_WIDTH", "C_BDST"):
        assert getattr(schedule, name) == getattr(scl_vm, name), name
    for args in [(1, True, False), (8, True, False), (8, False, False),
                 (8, True, True)]:
        assert schedule.scl_params(*args) == scl_vm.scl_params(*args)


@pytest.mark.parametrize("n,k,order", [(224, 144, 8), (960, 480, 10)])
def test_polar_code_matches(n, k, order):
    a, b = polar.PolarCode(n, k, order), jpolar.PolarCode(n, k, order)
    assert np.array_equal(a.info_idx, b.info_idx)
    assert np.array_equal(a.kept_idx, b.kept_idx)
    rng = np.random.default_rng(4)
    m = rng.integers(0, 2, (3, b.mesg_bits), dtype=np.uint8)
    m[:, b.k:] = 0
    cw = a.encode_systematic(torch.from_numpy(m)).numpy()
    assert np.array_equal(cw, b.encode_systematic_np(m))
    assert np.array_equal(a.shorten(torch.from_numpy(cw)).numpy(),
                          b.shorten_np(cw))
    llrs = rng.standard_normal((3, n)).astype(np.float32)
    assert np.array_equal(a.lengthen(torch.from_numpy(llrs)).numpy(),
                          b.lengthen_np(llrs))
    u = rng.integers(0, 2, (2, 1 << order), dtype=np.uint8)
    assert np.array_equal(polar.polar_transform(torch.from_numpy(u)).numpy(),
                          jpolar.polar_transform_np(u))


def test_polar_code_takes_given_mask():
    mask = freezer.frozen_mask(224, 144, 8)
    code = polar.PolarCode(224, 144, 8, frozen=mask.copy())
    assert np.array_equal(code.frozen, mask)
    with pytest.raises(ValueError):
        polar.PolarCode(224, 144, 8, frozen=mask[:-1])
