"""Port parity: the PHY codes and constants of the port vs the JAX package.

Bits, CRC, FEC, modem, subcarrier allocations and the frame constants
(preambles, pilots, sizing, GF(2) and FEC tables).  Both sides get the same
numpy arrays; integer results must be equal, constellation distances agree
within 1e-6 (float32 rounding of |x - point|^2).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu.phy import bits as jbits
from cognitive_radio_network_tpu.phy import crc as jcrc
from cognitive_radio_network_tpu.phy import fec as jfec
from cognitive_radio_network_tpu.phy import framegen as jframegen
from cognitive_radio_network_tpu.phy import modem as jmodem
from cognitive_radio_network_tpu.phy import subcarriers as jsub
from cognitive_radio_network_tpu_torch.phy import bits, crc, fec, framegen, modem, subcarriers


def _np(t):
    return t.cpu().numpy()


def test_bits_match_jax(rng):
    data = rng.integers(0, 256, (3, 32)).astype(np.uint8)
    got = bits.unpack_bits_tensor(torch.from_numpy(data))
    np.testing.assert_array_equal(_np(got), np.asarray(jbits.unpack_bits_jnp(jnp.asarray(data))))
    np.testing.assert_array_equal(_np(got), bits.unpack_bits(data))
    np.testing.assert_array_equal(_np(bits.pack_bits_tensor(got)), data)
    np.testing.assert_array_equal(
        _np(bits.pack_bits_tensor(got)), np.asarray(jbits.pack_bits_jnp(jnp.asarray(_np(got))))
    )
    np.testing.assert_array_equal(bits.pack_bits(bits.unpack_bits(data)), data)


# --- CRC -------------------------------------------------------------------


@pytest.mark.parametrize("scheme", crc.SCHEMES)
def test_crc_generate_matches_jax(rng, scheme):
    data = rng.integers(0, 256, (5, 37)).astype(np.uint8)
    np.testing.assert_array_equal(
        crc.crc_generate_batch(scheme, data), jcrc.crc_generate_batch(scheme, data)
    )
    for row in data:
        chk = crc.crc_generate(scheme, row)
        np.testing.assert_array_equal(chk, jcrc.crc_generate(scheme, row))
        assert crc.crc_validate(scheme, np.concatenate([row, chk]))


@pytest.mark.parametrize("scheme", crc.SCHEMES)
def test_crc_check_matches_jax_and_detects_corruption(rng, scheme):
    data = rng.integers(0, 256, (6, 40)).astype(np.uint8)
    dwc = np.concatenate([data, crc.crc_generate_batch(scheme, data)], axis=1)
    dwc[1, 3] ^= 0x40  # corrupt the data of row 1 and the check of row 4
    dwc[4, -1] ^= 0x01
    got = _np(crc.crc_check(scheme, torch.from_numpy(dwc)))
    want = np.asarray(jcrc.crc_check_jnp(scheme, jnp.asarray(dwc)))
    np.testing.assert_array_equal(got, want)
    expect = np.ones(6, bool)
    if scheme != "none":
        expect[[1, 4]] = False
    np.testing.assert_array_equal(got, expect)


def test_crc_table_scans_match_jax(rng):
    data = rng.integers(0, 256, (2, 3, 64)).astype(np.uint8)
    t = torch.from_numpy(data)
    np.testing.assert_array_equal(
        _np(crc.crc32_tensor(t)), np.asarray(jcrc.crc32_jnp(jnp.asarray(data))).astype(np.int64)
    )
    np.testing.assert_array_equal(
        _np(crc.crc16_tensor(t)), np.asarray(jcrc.crc16_jnp(jnp.asarray(data))).astype(np.int64)
    )
    # CRC-32/IEEE of ASCII "123456789" is 0xCBF43926.
    check = torch.from_numpy(np.frombuffer(b"123456789", np.uint8).copy())
    assert int(crc.crc32_tensor(check)) == 0xCBF43926


@pytest.mark.parametrize("scheme,n_bytes", [("crc16", 30), ("crc32", 22), ("crc32", 260)])
def test_crc_gf2_matrix_equal(scheme, n_bytes):
    cols, c0 = crc._crc_matrix(scheme, n_bytes)
    jcols, jc0 = jcrc._crc_matrix(scheme, n_bytes)
    np.testing.assert_array_equal(cols, jcols)
    np.testing.assert_array_equal(c0, jc0)


# --- FEC -------------------------------------------------------------------


@pytest.mark.parametrize("scheme", fec.SCHEMES)
def test_fec_host_encode_matches_jax(rng, scheme):
    data = rng.integers(0, 256, (3, 21)).astype(np.uint8)
    enc = fec.encode_batch(scheme, data)
    np.testing.assert_array_equal(enc, jfec.encode_batch(scheme, data))
    assert enc.shape[1] == fec.encoded_length(scheme, 21) == jfec.encoded_length(scheme, 21)
    for row, e in zip(data, enc):
        np.testing.assert_array_equal(fec.encode(scheme, row), e)
        np.testing.assert_array_equal(fec.decode(scheme, e, 21), row)


@pytest.mark.parametrize("scheme", fec.SCHEMES)
def test_decode_bits_clean_matches_jax(rng, scheme):
    data = rng.integers(0, 256, (4, 30)).astype(np.uint8)
    enc_bits = np.unpackbits(fec.encode_batch(scheme, data), axis=-1)
    got = _np(fec.decode_bits(scheme, torch.from_numpy(enc_bits), 30))
    np.testing.assert_array_equal(got, data)
    want = jfec.decode_bits_jnp(scheme, jnp.asarray(enc_bits), 30)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("scheme", ["rep3", "h74", "h128", "v27"])
def test_decode_bits_sparse_errors_matches_jax(rng, scheme):
    """One bit error per 23-bit stretch (within each code's correction
    power, as tests/test_phy_codes.py corrupts), at a different phase per
    frame of the batch."""
    data = rng.integers(0, 256, (3, 30)).astype(np.uint8)
    enc_bits = np.unpackbits(fec.encode_batch(scheme, data), axis=-1)
    for row in range(3):
        enc_bits[row, 5 + 7 * row : enc_bits.shape[1] - 8 : 23] ^= 1
    got = _np(fec.decode_bits(scheme, torch.from_numpy(enc_bits), 30))
    np.testing.assert_array_equal(got, data)
    want = jfec.decode_bits_jnp(scheme, jnp.asarray(enc_bits), 30)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_viterbi_batched_matches_jax_and_host(rng):
    """Batched over leading axes, with errors dense enough to leave some
    frames uncorrectable: every bit must still equal the reference's."""
    bits_in = rng.integers(0, 2, (2, 3, 40)).astype(np.uint8)
    coded = np.stack([
        np.stack([fec.conv_encode_bits(b) for b in plane]) for plane in bits_in
    ])
    flips = rng.random(coded.shape) < 0.06
    coded = coded ^ flips.astype(np.uint8)
    got = _np(fec.viterbi_decode(torch.from_numpy(coded), 40))
    assert got.shape == (2, 3, 40)
    np.testing.assert_array_equal(got, np.asarray(jfec.viterbi_decode_jnp(jnp.asarray(coded), 40)))
    for g, c in zip(got.reshape(-1, 40), coded.reshape(-1, coded.shape[-1])):
        np.testing.assert_array_equal(g, jfec.viterbi_decode_bits(c, 40))


@pytest.mark.parametrize(
    "table", ["_h74_tables", "_h128_matrices", "_h128_decode_table", "_conv_tables"]
)
def test_fec_tables_equal(table):
    got, want = getattr(fec, table)(), getattr(jfec, table)()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# --- modem -----------------------------------------------------------------


@pytest.mark.parametrize("scheme", modem.SCHEMES)
def test_modem_matches_jax(rng, scheme):
    pts = _np(modem.constellation(scheme))
    np.testing.assert_array_equal(pts, np.asarray(jmodem.constellation(scheme)))
    assert modem.bits_per_symbol(scheme) == jmodem.bits_per_symbol(scheme)
    syms = rng.integers(0, len(pts), (4, 50))
    x = _np(modem.modulate(scheme, torch.from_numpy(syms)))
    np.testing.assert_array_equal(x, np.asarray(jmodem.modulate(scheme, jnp.asarray(syms))))
    noisy = (x + 0.05 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))).astype(
        np.complex64
    )
    idx, evm = modem.demodulate(scheme, torch.from_numpy(noisy))
    jidx, jevm = jmodem.demodulate(scheme, jnp.asarray(noisy))
    assert idx.dtype == torch.int32 and evm.dtype == torch.float32
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    np.testing.assert_allclose(_np(evm), np.asarray(jevm), rtol=1e-5, atol=1e-6)


# --- subcarrier allocations ------------------------------------------------


@pytest.mark.parametrize("m", [16, 32, 64, 128])
def test_default_alloc_matches_jax(m):
    got = subcarriers.default_alloc(m)
    np.testing.assert_array_equal(got, jsub.default_alloc(m))
    assert subcarriers.counts(got) == jsub.counts(got)


@pytest.mark.parametrize("args", [(32, 2, 2, 4), (64, 4, 2, 8), (128, 10, 6, 12)])
def test_standard_alloc_matches_jax(args):
    np.testing.assert_array_equal(subcarriers.standard_alloc(*args), jsub.standard_alloc(*args))


def test_custom_alloc_matches_jax():
    spec = [("null", 1), ("data", 6), ("pilot", 1), ("data", 6), ("null", 4), ("data", 6),
            ("pilot", 1), ("data", 7)]
    np.testing.assert_array_equal(subcarriers.custom_alloc(32, spec), jsub.custom_alloc(32, spec))
    with pytest.raises(ValueError, match="longer than fft size"):
        subcarriers.custom_alloc(8, [("data", 9)])


# --- frame constants -------------------------------------------------------

_CONFIGS = {
    "default": {},
    "qam16-none": {"mod_scheme": "qam16", "fec0": "none"},
    "v27-v27": {"mod_scheme": "qam16", "fec0": "v27", "fec1": "v27"},
    "m64-std": {"num_subcarriers": 64, "cp_len": 8, "crc_scheme": "crc16",
                "subcarrier_alloc": tuple(int(v) for v in jsub.standard_alloc(64, 4, 2, 8))},
}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_frame_constants_match_jax(rng, name):
    kw, payload_len = _CONFIGS[name], 48
    gen = framegen.OFDMFrameGen(framegen.OFDMFrameConfig(**kw), payload_len)
    jgen = jframegen.OFDMFrameGen(jframegen.OFDMFrameConfig(**kw), payload_len)
    for attr in ("alloc", "data_idx", "pilot_idx", "active_idx", "S0_freq", "S1_freq",
                 "S0_time", "S1_time", "pilots"):
        np.testing.assert_array_equal(getattr(gen, attr), getattr(jgen, attr), err_msg=attr)
    for attr in ("n_header_bits", "n_header_syms", "payload_enc_bytes", "n_payload_syms", "bps",
                 "num_symbols", "frame_len"):
        assert getattr(gen, attr) == getattr(jgen, attr), attr
    assert dataclasses.asdict(gen.cfg) == dataclasses.asdict(jgen.cfg)
    phy = framegen.pack_phy_header(gen.cfg, payload_len)
    np.testing.assert_array_equal(phy, jframegen.pack_phy_header(jgen.cfg, payload_len))
    assert framegen.unpack_phy_header(phy) == jframegen.unpack_phy_header(phy)
    headers = rng.integers(0, 256, (3, 8)).astype(np.uint8)
    payloads = rng.integers(0, 256, (3, payload_len)).astype(np.uint8)
    np.testing.assert_array_equal(gen.encode_header_batch(headers),
                                  jgen.encode_header_batch(headers))
    np.testing.assert_array_equal(gen.encode_payload_batch(payloads),
                                  jgen.encode_payload_batch(payloads))
    np.testing.assert_array_equal(gen.encode_header(headers[0]), jgen.encode_header(headers[0]))
    np.testing.assert_array_equal(gen.encode_payload(payloads[0]), jgen.encode_payload(payloads[0]))
