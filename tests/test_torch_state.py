"""State carried across: the arrays the JAX package builds (frozen mask,
schedule, CRC-32 check matrix, MLS0 kernel, encoder spectra) equal the
port's own builders', and the port run from the JAX arrays through
state_from_numpy decodes as the JAX pipeline does."""

import numpy as np
import pytest
import torch

from modem_tpu import bits as jbits
from modem_tpu.encoder import Encoder as JaxEncoder
from modem_tpu.fec.scl_vm import build_schedule as jax_build_schedule
from modem_tpu.parallel import toy_config as jax_toy_config
from modem_tpu.parallel import toy_recordings
from modem_tpu.pipeline import BatchPipeline as JaxBatchPipeline
from modem_tpu_torch.encoder import Encoder
from modem_tpu_torch.numerology import make_config, toy_config
from modem_tpu_torch.pipeline import BatchPipeline
from modem_tpu_torch.state import ARRAYS, build_state, state_from_numpy


def jax_arrays(jcfg, enc_cfg=None):
    """The state arrays as the JAX package builds them (numpy)."""
    pipe = JaxBatchPipeline(rate=jcfg.rate, oper_mode=jcfg.mode.oper_mode,
                            list_size=1, mode_spec=jcfg.mode,
                            symbol_len_override=jcfg.symbol_len_override)
    enc = JaxEncoder(enc_cfg or jcfg)
    frozen = np.asarray(pipe.code.frozen, np.uint8)
    return pipe, dict(
        frozen=frozen,
        schedule=jax_build_schedule(frozen.tobytes(), emit_spc=True).ops,
        crc_matrix=pipe.crc_mat, mls0_kernel=pipe.sync.kerns[0],
        pilot_fdom=enc.pilot_fdom, sc_fdom=enc.sc_fdom,
        mls1_seq=enc.mls1_seq)


@pytest.fixture(scope="module")
def toy():
    return jax_arrays(jax_toy_config())


def check_builders_match(state, arrays):
    for name in ("frozen", "schedule", "crc_matrix", "pilot_fdom",
                 "sc_fdom", "mls1_seq"):
        got = getattr(state, name).numpy()
        want = np.asarray(arrays[name])
        assert np.array_equal(got, want.astype(got.dtype)), name
    kern = arrays["mls0_kernel"]
    assert np.allclose(state.mls0_kernel.numpy(),
                       kern[:, 0] + 1j * kern[:, 1], atol=1e-6)


def test_toy_builders_match_jax_arrays(toy):
    _pipe, arrays = toy
    check_builders_match(build_state(toy_config()), arrays)


def test_wire_builders_match_jax_arrays():
    """Mode 6 at 8 kHz, the serving configuration."""
    from modem_tpu.numerology import make_config as jax_make_config
    _pipe, arrays = jax_arrays(jax_make_config(8000, 6))
    state = build_state(make_config(8000, 6))
    check_builders_match(state, arrays)
    assert state.schedule.shape == (10252, 14)
    assert state.crc_matrix.shape == (43072, 32)


def test_state_from_numpy_types_and_names(toy):
    _pipe, arrays = toy
    state = state_from_numpy(**arrays)
    assert state.mls0_kernel.dtype == torch.complex64
    assert state.schedule.dtype == torch.int32
    assert state.frozen.dtype == torch.uint8
    assert set(ARRAYS) == set(arrays)
    with pytest.raises(TypeError):
        state_from_numpy(weights=np.zeros(3))
    with pytest.raises(ValueError):
        state_from_numpy(mls0_kernel=np.zeros((4, 3), np.float32))


def test_pipeline_from_jax_state_matches(toy):
    """The port built from the JAX package's own arrays decodes exactly
    as the JAX pipeline and as the port built from its own arrays."""
    jpipe, arrays = toy
    cfg = toy_config()
    port = BatchPipeline(rate=cfg.rate, oper_mode=0, mode_spec=cfg.mode,
                         symbol_len_override=cfg.symbol_len,
                         state=state_from_numpy(**arrays))
    own = BatchPipeline(rate=cfg.rate, oper_mode=0, mode_spec=cfg.mode,
                        symbol_len_override=cfg.symbol_len)
    recs, payloads = toy_recordings(4, seed=17)
    rng = np.random.default_rng(18)
    x = np.asarray(recs) + 0.2 * rng.standard_normal(
        np.asarray(recs).shape).astype(np.float32)
    got = port.fetch(port.decode_batch(x))
    mine = own.fetch(own.decode_batch(x))
    want = jpipe.fetch(jpipe.decode_batch(x))
    for key in ("ok", "bits", "p0", "flips", "sync_gate"):
        assert np.array_equal(got[key], want[key]), key
        assert np.array_equal(got[key], mine[key]), key
    assert np.array_equal(got["snr"], mine["snr"])


def test_encoder_from_jax_state_matches(toy):
    _pipe, arrays = toy
    enc = Encoder(toy_config(), state=state_from_numpy(**arrays))
    own = Encoder(toy_config())
    payload = bytes(range(toy_config().mode.data_bytes))
    call = jbits.base37_encode("TOY")
    a, _ = enc.encode_batch([payload], call)
    b, _ = own.encode_batch([payload], call)
    assert torch.equal(a, b)
