"""The port's CUDA kernels and pipelines on the card, against their plain
versions and CPU runs; every test needs a CUDA device and skips without
one.

The file imports neither jax nor the JAX package, so it runs on a GPU
machine without JAX (``--noconftest`` skips tests/conftest.py, which
imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q
"""

import functools
import os
import wave

import numpy as np
import pytest
import torch

from modem_tpu_torch import bits as B
from modem_tpu_torch.decoder import Decoder
from modem_tpu_torch.encoder import Encoder
from modem_tpu_torch.fec.polar import PolarCode
from modem_tpu_torch.kernels.sc_decode import (ScPlan, sc_decode,
                                               sc_decode_reference)
from modem_tpu_torch.kernels.scl_decode import (scl_decode,
                                                scl_decode_reference)
from modem_tpu_torch.numerology import toy_config
from modem_tpu_torch.pipeline import AdaptivePipeline, BatchPipeline

# (n, k, order, sigma) as tests/test_torch_sc_decode.py and
# tests/test_torch_scl_decode.py
CODES = {"toy": (224, 144, 8, 0.75), "chunked": (960, 480, 10, 0.85),
         "narrow": (56, 36, 6, 0.8)}
EXACT_KEYS = ("ok", "bits", "p0", "flips", "sync_gate")
WIRE = (64800, 43072, 16, 0.70)   # wire size at the list decoders' edge
_DATA = os.path.join(os.path.dirname(__file__), "data")


def noisy_llrs(n, k, order, sigma, frames=16, seed=9):
    """Seeded noisy LLRs of one random codeword, [frames, code_len] f32:
    bit for bit tests/test_torch_sc_decode.py's JAX-made ones (pinned
    there)."""
    code = PolarCode(n, k, order)
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2, code.mesg_bits, dtype=np.uint8)
    m[code.k:] = 0
    cw = code.encode_systematic(torch.from_numpy(m))
    tx = 1.0 - 2.0 * code.shorten(cw).double()
    noise = torch.from_numpy(rng.standard_normal((frames, code.n)))
    return code, code.lengthen(2.0 * (tx + sigma * noise) / sigma ** 2
                               ).float()


@functools.lru_cache(maxsize=None)
def toy_batches():
    """tests/test_torch_pipeline.py's toy batches made without JAX: 8
    recordings of the payloads of modem_tpu.parallel.toy_recordings(8,
    seed=3) by the port's encoder, clean and with the same seeded noise
    of sigma 0.05 and 0.3, split-complex [8, T, 2] numpy.  That file
    pins the port's decode of these equal to the JAX package's decode
    of its own recordings."""
    cfg = toy_config()
    rng = np.random.default_rng(3)
    payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes() for _ in range(8)]
    waves, _ = Encoder(cfg, device="cpu").encode_batch(
        payloads, B.base37_encode("TOY"))
    pad = torch.zeros(8, cfg.symbol_len, dtype=torch.complex64)
    recs = torch.view_as_real(torch.cat([pad, waves, pad], dim=1)).numpy()
    rng = np.random.default_rng(42)
    out = {0.0: recs}
    for sigma in (0.05, 0.3):
        out[sigma] = recs + sigma * rng.standard_normal(recs.shape).astype(
            np.float32)
    return out


def toy_pipeline(cls, device, **kw):
    cfg = toy_config()
    return cls(rate=cfg.rate, oper_mode=0, mode_spec=cfg.mode,
               symbol_len_override=cfg.symbol_len, device=device, **kw)


def assert_same_result(got: dict, want: dict):
    for key in EXACT_KEYS:
        assert np.array_equal(got[key], want[key]), key


def rows_sorted(a: torch.Tensor) -> np.ndarray:
    a = a.cpu().numpy()
    return a[np.lexsort(a.T[::-1])]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chunked", "toy"])
def test_kernel_matches_plain_version_on_card(cuda_device, name):
    """Kernel A against its plain version: codewords equal, path metrics
    within rtol 1e-5, atol 1e-3."""
    code, llrs = noisy_llrs(*CODES[name])
    plan = ScPlan.from_frozen(code.frozen)
    x = llrs.to(cuda_device)
    before = sc_decode.launches
    cw, pm = sc_decode(x, plan)
    torch.cuda.synchronize()
    assert sc_decode.launches == before + 1
    cw_r, pm_r = sc_decode_reference(x, plan.sched)
    assert torch.equal(cw, cw_r)
    assert torch.allclose(pm, pm_r, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [0.0, 0.05, 0.3])
def test_card_decode_matches_cpu(cuda_device, sigma):
    """The toy BatchPipeline(list_size=1) on the card, through kernel A,
    against the CPU run of the same batch: ok, bits, p0, flips and
    sync_gate equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = toy_batches()[sigma]
    cpu = toy_pipeline(BatchPipeline, "cpu", list_size=1)
    card = toy_pipeline(BatchPipeline, cuda_device, list_size=1)
    before = sc_decode.launches
    got = card.fetch(card.decode_batch(x))
    assert sc_decode.launches == before + 1
    want = cpu.fetch(cpu.decode_batch(x))
    assert_same_result(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CODES))
@pytest.mark.parametrize("lsz", [2, 4, 8])
def test_list_kernel_matches_plain_version(cuda_device, name, lsz):
    """Kernel B against its plain version on the same card tensors: the
    same codewords in every list, sorted path metrics within rtol 1e-5,
    atol 1e-3 (penalty sums reduced in another order)."""
    code, llrs = noisy_llrs(*CODES[name])
    plan = ScPlan.from_frozen(code.frozen)
    x = llrs.to(cuda_device)
    before = scl_decode.launches
    cw, pm = scl_decode(x, plan, lsz)
    torch.cuda.synchronize()
    assert scl_decode.launches == before + 1
    cw_r, pm_r = scl_decode_reference(x, plan.sched, lsz)
    assert cw.shape == cw_r.shape == (len(llrs), lsz, code.code_len)
    for b in range(len(llrs)):
        assert np.array_equal(rows_sorted(cw[b]), rows_sorted(cw_r[b])), b
    assert torch.allclose(pm.sort(dim=1).values, pm_r.sort(dim=1).values,
                          rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_adaptive_pipeline_matches_cpu(cuda_device):
    """The toy AdaptivePipeline(list_size=4) on the card, through both
    kernels, against its CPU run on the sigma 0.3 batch, which
    escalates: the same fallbacks, and ok, bits, p0, flips and
    sync_gate equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    recs = toy_batches()[0.3]
    cpu = toy_pipeline(AdaptivePipeline, "cpu", list_size=4)
    card = toy_pipeline(AdaptivePipeline, cuda_device, list_size=4)
    sc0, scl0 = sc_decode.launches, scl_decode.launches
    got = card.decode_batch(recs)
    assert sc_decode.launches == sc0 + 1 and scl_decode.launches > scl0
    want = cpu.decode_batch(recs)
    assert card.last_fallbacks == cpu.last_fallbacks > 0
    assert_same_result(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,lsz", [(n, lsz) for n in sorted(CODES)
                                      for lsz in (2, 4, 8)] + [("wire", 8)])
def test_fast_list_kernel_matches_plain_version(cuda_device, name, lsz):
    """Kernel C (scl_exact=False) against its plain version on the same
    card tensors, toy codes at L = 2, 4, 8 and 16 wire-size frames at
    L = 8: the same codewords in every list, in the same lane order,
    sorted path metrics within rtol 1e-5, atol 1e-3."""
    code, llrs = noisy_llrs(*(WIRE if name == "wire" else CODES[name]))
    plan = ScPlan.from_frozen(code.frozen)
    x = llrs.to(cuda_device)
    before = scl_decode.launches, scl_decode.fast_launches
    cw, pm = scl_decode(x, plan, lsz, exact=False)
    torch.cuda.synchronize()
    assert (scl_decode.launches, scl_decode.fast_launches) == (
        before[0], before[1] + 1)
    cw_r, pm_r = scl_decode_reference(x, plan.sched, lsz, exact=False)
    for b in range(len(llrs)):
        assert np.array_equal(rows_sorted(cw[b]), rows_sorted(cw_r[b])), b
    assert torch.equal(cw, cw_r)
    assert torch.allclose(pm.sort(dim=1).values, pm_r.sort(dim=1).values,
                          rtol=1e-5, atol=1e-3)


def read_golden() -> np.ndarray:
    with wave.open(os.path.join(_DATA, "golden_mode6_galois.wav")) as f:
        raw = np.frombuffer(f.readframes(f.getnframes()),
                            dtype="<i2").reshape(-1, 2)
    x = raw.astype(np.float32) / 32767.0
    return (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("scl_exact", [True, False])
@pytest.mark.parametrize("channels", [2, 1])
def test_decoder_golden_on_card(cuda_device, scl_exact, channels):
    """The interactive Decoder on the card decodes the golden recording
    byte-exact through kernel B (or C), and agrees with its CPU run on
    ok, payload, mode, call sign, symbol position and bit flips."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = read_golden()
    samples = rec if channels == 2 else rec.real.copy()
    want_payload = np.load(os.path.join(
        _DATA, "waveform_pin_payload_seed.npy")).tobytes()
    card = Decoder(8000, scl_exact=scl_exact, device=cuda_device)
    before = scl_decode.launches, scl_decode.fast_launches
    got = card.decode(samples, channels=channels)
    after = scl_decode.launches, scl_decode.fast_launches
    assert after == ((before[0] + 1, before[1]) if scl_exact
                     else (before[0], before[1] + 1))
    want = Decoder(8000, scl_exact=scl_exact, device="cpu").decode(
        samples, channels=channels)
    assert got.ok and got.payload == want.payload == want_payload
    for key in ("oper_mode", "call_sign", "symbol_pos", "bit_flips"):
        assert getattr(got, key) == getattr(want, key), key
