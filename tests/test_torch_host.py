"""The port's numpy host modules equal the JAX package's originals:
numerology, bits (CRC, scrambler, MLS, base37, MSB-first packing), the
frozen-set design, the BCH encoder and codeword check, the decoder
schedule, the polar transforms and their numpy twins, the PSK map's
numpy twin, and the exhaustive OSD oracle (``fec/osd_np``), which the
port's batched ``fec.osd.osd_decode`` equals in turn; and the
signatures JAX callers use (``osd_decode(order=)``,
``encode_systematic(mesg_bits=)``)."""

import inspect

import numpy as np
import pytest
import torch

from modem_tpu import bits as jbits
from modem_tpu import numerology as jnum
from modem_tpu import psk as jpsk
from modem_tpu.fec import bch as jbch
from modem_tpu.fec import freezer as jfreezer
from modem_tpu.fec import osd_np as josd_np
from modem_tpu.fec import polar as jpolar
from modem_tpu.fec import scl_vm
from modem_tpu.parallel import toy_config as jax_toy_config
from modem_tpu_torch import bits, numerology, psk
from modem_tpu_torch.fec import bch, freezer, osd, osd_np, polar, schedule


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
    """The other conventions are ported (tests/test_torch_mls.py holds
    all three); an unknown one raises as in the JAX package."""
    assert np.array_equal(
        bits.mls_bits(numerology.MLS0_POLY, 8, convention="msb"),
        jbits.mls_bits(numerology.MLS0_POLY, 8, convention="msb"))
    with pytest.raises(ValueError):
        bits.mls_bits(numerology.MLS0_POLY, 8, convention="lsb")


@pytest.mark.parametrize("text", ["N0CALL", "toy", "A B", "a!b", ""])
def test_base37_matches(text):
    assert bits.base37_encode(text) == jbits.base37_encode(text)


@pytest.mark.parametrize("text", ["N0CALL", "TOY", "A B", "Z9", ""])
def test_base37_decode_matches(text):
    value = jbits.base37_encode(text)
    assert bits.base37_decode(value) == jbits.base37_decode(value)
    assert bits.base37_decode(value).lstrip() == text.upper().lstrip()


@pytest.mark.parametrize("n,k,order", [(224, 144, 8), (960, 480, 10),
                                       (64800, 43072, 16),
                                       (64512, 43072, 16)])
def test_frozen_mask_matches(n, k, order):
    assert np.array_equal(freezer.frozen_mask(n, k, order),
                          jfreezer.frozen_mask(n, k, order))


@pytest.mark.parametrize("n,k", [(64800, 43072), (64512, 43072),
                                 (224, 144)])
def test_mask_words_match(n, k):
    """The table packing of the freezer command: uint32 words as the JAX
    package packs them, and back."""
    order = 16 if n > 1024 else 8
    mask = freezer.frozen_mask(n, k, order)
    words = freezer.mask_to_words(mask)
    assert words.dtype == np.uint32 and len(words) == len(mask) // 32
    assert np.array_equal(words, jfreezer.mask_to_words(mask))
    assert np.array_equal(freezer.words_to_mask(words), mask)
    assert np.array_equal(freezer.words_to_mask(words),
                          jfreezer.words_to_mask(words))


def test_bch_encode_matches():
    rng = np.random.default_rng(3)
    for _ in range(4):
        d = rng.integers(0, 2, 71, dtype=np.uint8)
        assert np.array_equal(bch.encode(d), jbch.encode(d))


def test_bch_generator_matrix_matches():
    g = bch.generator_matrix()
    assert g.dtype == np.uint8 and g.shape == (71, 255)
    assert np.array_equal(g, jbch.generator_matrix())


@pytest.mark.parametrize("lsz", [2, 4, 8])
@pytest.mark.parametrize("exact", [True, False])
def test_scl_params_match(lsz, exact):
    """The leaf rules of both list modes: exact one-shot, or T_RATE1 = 4
    serial rounds (fast)."""
    assert schedule.T_RATE1 == scl_vm.T_RATE1 == 4
    assert (schedule.scl_params(lsz, exact, False)
            == scl_vm.scl_params(lsz, exact, False))


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


@pytest.mark.parametrize("rate", [8000, 16000, 44100, 48000])
@pytest.mark.parametrize("convention", ["galois", "msb", "auto"])
def test_receiver_geometry_matches(rate, convention):
    """The PCM front end's DC window, taps and raw lead, and the
    synchroniser's conventions, as the JAX synchroniser sets them."""
    import dataclasses

    from modem_tpu.ingest import front_lead as jax_front_lead
    from modem_tpu.sync import Synchronizer as JaxSynchronizer
    from modem_tpu_torch.ingest import front_lead
    from modem_tpu_torch.sync import Synchronizer, mls0_kernel

    cfg = dataclasses.replace(numerology.make_config(rate, 6), freq_off=0,
                              mls_convention=convention)
    jcfg = dataclasses.replace(jnum.make_config(rate, 6), freq_off=0,
                               mls_convention=convention)
    port, ref = Synchronizer(cfg, "cpu"), JaxSynchronizer(jcfg)
    assert (port.dc_window, port.taps, port.front_lead) == (
        ref.dc_window, ref.taps, ref.front_lead)
    assert front_lead(port.dc_window, port.taps) == jax_front_lead(
        ref.dc_window, ref.taps)
    assert port.conventions == ref.conventions
    kern = mls0_kernel(cfg)
    assert kern.shape == ((3, port.L) if convention == "auto" else (port.L,))
    assert np.allclose(kern.reshape(-1, port.L),
                       ref.kerns[..., 0] + 1j * ref.kerns[..., 1], atol=1e-6)


# -- the numpy helpers --------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 9, 640])
def test_be_packing_and_payload_crc_match(n):
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    b = bits.bytes_to_bits_be(data)
    assert b.dtype == np.uint8
    assert np.array_equal(b, jbits.bytes_to_bits_be(data))
    assert bits.bits_to_bytes_be(b) == jbits.bits_to_bytes_be(b) == data
    odd = np.random.default_rng(n).integers(0, 2, 8 * n + 5, dtype=np.uint8)
    assert bits.bits_to_bytes_be(odd) == jbits.bits_to_bytes_be(odd)
    assert bits.payload_crc32(data) == jbits.payload_crc32(data)


@pytest.mark.parametrize("n,k,order", [(224, 144, 8), (960, 480, 10),
                                       (64800, 43072, 16)])
def test_polar_numpy_twins_match(n, k, order):
    a, b = polar.PolarCode(n, k, order), jpolar.PolarCode(n, k, order)
    assert np.array_equal(a.frozen, b.frozen)
    assert np.array_equal(a.shortened_idx, b.shortened_idx)
    rng = np.random.default_rng(order)
    m = rng.integers(0, 2, (2, b.mesg_bits), dtype=np.uint8)
    cw = a.encode_systematic_np(m)
    assert np.array_equal(cw, b.encode_systematic_np(m))
    assert np.array_equal(cw, a.encode_systematic(torch.from_numpy(m)).numpy())
    assert np.array_equal(a.shorten_np(cw), b.shorten_np(cw))
    assert np.array_equal(a.extract_info_np(cw), b.extract_info_np(cw))
    assert np.array_equal(a.extract_info_np(cw), m[:, : k])
    llrs = rng.standard_normal((2, n)).astype(np.float32)
    assert np.array_equal(a.lengthen_np(llrs), b.lengthen_np(llrs))
    assert np.array_equal(a.lengthen_np(llrs, 5.0),
                          b.lengthen_np(llrs, 5.0))
    u = rng.integers(0, 2, (2, 1 << order), dtype=np.uint8)
    assert np.array_equal(polar.polar_transform_np(u),
                          jpolar.polar_transform_np(u))


@pytest.mark.parametrize("n", [64800, 64512])
def test_wire_code_matches(n):
    a, b = polar.wire_code(n), jpolar.wire_code(n)
    assert a is polar.wire_code(n)
    assert (a.n, a.k, a.order, a.code_len, a.mesg_bits) == (
        b.n, b.k, b.order, b.code_len, b.mesg_bits)
    assert np.array_equal(a.frozen, b.frozen)
    assert np.array_equal(a.kept_idx, b.kept_idx)


@pytest.mark.parametrize("mod_bits", [1, 2, 3])
def test_mod_map_np_matches(mod_bits):
    rng = np.random.default_rng(mod_bits)
    nrz = 1.0 - 2.0 * rng.integers(0, 2, (5, 7, mod_bits))
    got = psk.mod_map_np(mod_bits, nrz)
    assert got.dtype == np.complex128
    assert np.array_equal(got, jpsk.mod_map_np(mod_bits, nrz))
    assert np.allclose(got, psk.mod_map(mod_bits, torch.from_numpy(
        nrz)).numpy(), atol=1e-6)


def test_is_codeword_matches():
    g = bch.generator_matrix()
    rng = np.random.default_rng(6)
    for _ in range(3):
        cw = (rng.integers(0, 2, 71, dtype=np.uint8) @ g) % 2
        bad = cw.copy()
        bad[rng.integers(0, 255)] ^= 1
        assert bch.is_codeword(cw) and jbch.is_codeword(cw)
        assert not bch.is_codeword(bad) and not jbch.is_codeword(bad)


@pytest.mark.parametrize("n,k,order", [(224, 144, 8), (960, 480, 10),
                                       (64800, 43072, 16),
                                       (64800, 43104, 16)])
def test_cached_frozen_mask_matches(n, k, order):
    """Against the JAX package's tables on disk (fec/tables)."""
    assert np.array_equal(freezer.cached_frozen_mask(n, k, order),
                          jfreezer.cached_frozen_mask(n, k, order))


# -- the exhaustive OSD oracle -------------------------------------------------

def _osd_soft(case):
    """tests/test_osd.py's regimes: the sensitivity edge, coarse
    quantisation (frequent ties) and a block of erasures only."""
    if case == "erased":
        return np.zeros(255)
    sigma, quant = {"edge": (0.9, 32), "coarse": (1.0, 4)}[case]
    rng = np.random.default_rng(777 + quant)
    u = rng.integers(0, 2, 71, dtype=np.uint8)
    x = (1.0 - 2.0 * ((u @ bch.generator_matrix()) % 2)
         + rng.normal(0, sigma, 255))
    return np.clip(np.rint(x * quant), -127, 127).astype(np.float64)


@pytest.mark.parametrize("case", ["edge", "coarse", "erased"])
def test_osd_np_matches_jax(case):
    """Every field of the oracle equals JAX's, and the port's batched
    matmul OSD equals the oracle (data bits and the uniqueness flag)."""
    soft = _osd_soft(case)
    g = bch.generator_matrix()
    perm = np.argsort(-np.abs(soft), kind="stable")
    red, piv = osd_np._rref_gf2_np(g[:, perm], 71)
    jred, jpiv = josd_np._rref_gf2_np(g[:, perm], 71)
    assert np.array_equal(red, jred) and np.array_equal(piv, jpiv)
    data, unique = osd_np.osd_decode_np(soft)
    jdata, junique = josd_np.osd_decode_np(soft)
    assert data.dtype == np.uint8 and np.array_equal(data, jdata)
    assert unique == junique and isinstance(unique, bool)
    bd, bu = osd.osd_decode(torch.from_numpy(soft[None]).to(torch.int8))
    assert np.array_equal(bd[0].numpy(), data) and bool(bu[0]) == unique
    assert unique == (case != "erased")


# -- signatures the JAX package's callers use ----------------------------------

def test_osd_decode_signature_matches_jax():
    """osd_decode takes the JAX one's parameters by the same names: order
    4 (the reference's search) decodes as the default does, and another
    order raises ValueError (JAX asserts it)."""
    from modem_tpu.fec import osd as josd
    assert list(inspect.signature(osd.osd_decode).parameters) == list(
        inspect.signature(josd.osd_decode).parameters)
    soft = torch.from_numpy(_osd_soft("edge")[None]).to(torch.int8)
    got = osd.osd_decode(soft, genmat=bch.generator_matrix(), order=4)
    want = osd.osd_decode(soft)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for order in (3, 5):
        with pytest.raises(ValueError):
            osd.osd_decode(soft, order=order)


def test_encode_systematic_takes_mesg_bits():
    """PolarCode.encode_systematic(mesg_bits=...) as JAX's names it,
    equal to the JAX encoder's codeword."""
    a, b = polar.PolarCode(224, 144, 8), jpolar.PolarCode(224, 144, 8)
    assert list(inspect.signature(a.encode_systematic).parameters) == list(
        inspect.signature(b.encode_systematic).parameters) == ["mesg_bits"]
    rng = np.random.default_rng(11)
    m = rng.integers(0, 2, (2, b.mesg_bits), dtype=np.uint8)
    m[:, b.k:] = 0
    got = a.encode_systematic(mesg_bits=torch.from_numpy(m)).numpy()
    assert np.array_equal(got, np.asarray(b.encode_systematic(mesg_bits=m)))
