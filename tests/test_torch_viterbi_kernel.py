"""The v27 Viterbi decoder: the kernel (``ops/viterbi.py::viterbi_decode_k7``,
``csrc/viterbi_k7.cu``) against the plain loop, and the dispatch of
``phy/fec.py::viterbi_decode`` by the tensor's device.

The tests marked ``cuda`` need a CUDA card and skip without one (the condition
is a string, evaluated when each test runs).  On a GPU machine
(``--noconftest``: tests/conftest.py imports JAX, which a machine for the port
need not have):

    python -m pytest tests/test_torch_viterbi_kernel.py -m cuda --noconftest -q

The decoder is integers only, so the kernel must equal the plain version bit
for bit (``torch.equal``) on every input: random coded bits (ties are
common), encoded payloads with flipped bits, and any bytes.  The plain version
runs on CPU copies of the inputs: it is the same function on either device,
and much faster on the CPU than as ~5 launches a step on the card.  The other
tests run on the CPU and need no card.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu_torch.ops.viterbi import (
    MAX_BITS,
    frames_at_one_stride,
    viterbi_decode_k7,
    viterbi_decode_plain,
)
from cognitive_radio_network_tpu_torch.phy import fec
from cognitive_radio_network_tpu_torch.phy.framegen import OFDMFrameConfig, OFDMFrameGen
from cognitive_radio_network_tpu_torch.phy.stream import StreamReceiver
from cognitive_radio_network_tpu_torch.utils import profiling

needs_card = pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")

# the frame lengths of a 256-byte crc32 packet: outer code 2,080 bits, inner
# 4,176; and one of 20 of the kernel's 2,048-step chunks, past 28,512 steps
LONG = 40_000


def _coded(kind: str, shape: tuple, n_bits: int, extra: int = 0, seed: int = 0) -> np.ndarray:
    """Coded bits (*shape, 2 * (n_bits + 6) + extra) uint8."""
    rng = np.random.default_rng([seed, n_bits, extra, len(kind)])
    n = 2 * (n_bits + 6) + extra
    b = int(np.prod(shape))
    if kind == "random":
        coded = rng.integers(0, 2, (b, n))
    elif kind == "bytes":
        coded = rng.integers(0, 256, (b, n))
    else:  # encoded payloads with about 4% of the coded bits flipped
        msgs = rng.integers(0, 2, (b, n_bits)).astype(np.uint8)
        coded = np.concatenate(
            [fec.conv_encode_bits_batch(msgs), rng.integers(0, 2, (b, extra))], axis=1
        )
        coded ^= (rng.random(coded.shape) < 0.04).astype(coded.dtype)
    return coded.astype(np.uint8).reshape(*shape, n)


def _k7_and_plain(coded: np.ndarray, n_bits: int):
    host = torch.from_numpy(coded)
    got = viterbi_decode_k7(host.cuda(), n_bits)
    want = viterbi_decode_plain(host, n_bits)
    torch.cuda.synchronize()
    return got.cpu(), want


# --- on the card ------------------------------------------------------------------


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("kind", ["random", "flipped"])
@pytest.mark.parametrize("n_bits", [8, 40, 2080, 4172, 4176, LONG])
@pytest.mark.parametrize("extra", [0, 5])
def test_kernel_equals_plain(n_bits, kind, extra):
    """Rows of exactly 2 * (n_bits + 6) coded bits, and rows 5 bits longer
    (an odd stride: every row but the first starts off a 16-byte boundary)."""
    got, want = _k7_and_plain(_coded(kind, (3,), n_bits, extra), n_bits)
    assert got.shape == (3, n_bits) and got.dtype == torch.uint8
    assert torch.equal(got, want)


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("shape", [(1,), (37,), (2, 3)])
def test_kernel_batch_shapes_equal_plain(shape):
    got, want = _k7_and_plain(_coded("random", shape, 2080), 2080)
    assert got.shape == (*shape, 2080) and torch.equal(got, want)


@pytest.mark.cuda
@needs_card
def test_kernel_takes_any_bytes_and_views_in_place():
    """Bytes other than 0 and 1 decode as the plain version's formula says; a
    contiguous view that starts 1 byte into its storage, the first bits of
    longer rows (the receiver's demodulator hands its payload bits over so)
    and one frame repeated at stride 0 are read in place."""
    coded = _coded("bytes", (5,), 300)
    got, want = _k7_and_plain(coded, 300)
    assert torch.equal(got, want)
    flat = torch.from_numpy(np.random.default_rng(1).integers(0, 2, 4 * 612 + 1).astype(np.uint8))
    wide = torch.from_numpy(_coded("flipped", (2, 3), 300, extra=101))
    views = [flat.cuda()[1:].reshape(4, 612), wide.cuda()[..., :612],
             wide[0, 0].cuda().expand(5, 713)]
    assert views[0].is_contiguous() and views[0].storage_offset() == 1
    assert not views[1].is_contiguous() and views[2].stride() == (0, 1)
    for view in views:
        got = viterbi_decode_k7(view, 300)
        assert torch.equal(got.cpu(), viterbi_decode_plain(view.cpu(), 300))


@pytest.mark.cuda
@needs_card
def test_kernel_rejects_bad_input_on_the_card():
    coded = torch.from_numpy(_coded("random", (4,), 40)).cuda()
    with pytest.raises(ValueError, match="uint8"):
        viterbi_decode_k7(coded.long(), 40)
    with pytest.raises(ValueError, match="92 coded bits"):
        viterbi_decode_k7(coded[:, :-1].contiguous(), 40)
    with pytest.raises(ValueError, match="unit stride"):
        viterbi_decode_k7(coded.repeat(1, 2)[:, ::2], 40)


@pytest.mark.cuda
@needs_card
def test_one_launch_per_call():
    coded = torch.from_numpy(_coded("flipped", (2, 3), 2080)).cuda()
    before = viterbi_decode_k7.launches
    with profiling.recording() as recs:
        with profiling.span("decode"):
            got = fec.viterbi_decode(coded, 2080)
            fec.decode_bits("v27", coded, 260)  # packed to bytes after one launch
    assert viterbi_decode_k7.launches == before + 2
    assert recs[0]["counts"] == {"fec.viterbi_kernel_frames": 12}  # no host steps on the card
    assert torch.equal(got.cpu(), viterbi_decode_plain(coded.cpu(), 2080))
    assert viterbi_decode_k7(coded[:0], 2080).shape == (0, 3, 2080)  # no frame: no launch
    assert viterbi_decode_k7.launches == before + 2


@pytest.mark.cuda
@needs_card
def test_fec_decode_casts_and_copies_on_the_card():
    """``fec.viterbi_decode`` on the card takes any integer dtype of bits and
    frames the kernel cannot read in place (the plain loop's inputs), by a
    cast and a copy on the card, then one launch."""
    wide = torch.from_numpy(_coded("flipped", (2, 3), 300, extra=101))
    inputs = [wide[..., :612].long(), wide.permute(1, 0, 2)[..., :612]]
    assert not frames_at_one_stride(inputs[1])
    for coded in inputs:
        before = viterbi_decode_k7.launches
        got = fec.viterbi_decode(coded.cuda(), 300)
        assert viterbi_decode_k7.launches == before + 1
        assert torch.equal(got.cpu(), viterbi_decode_plain(coded, 300))


def _v27_tape(frames=4, payload_len=256, seed=11):
    """predictive_model's SU link (qam16, crc32, v27+v27) in light noise."""
    rng = np.random.default_rng(seed)
    cfg = OFDMFrameConfig(mod_scheme="qam16", fec0="v27", fec1="v27", crc_scheme="crc32")
    gen = OFDMFrameGen(cfg, payload_len)
    headers = rng.integers(0, 256, (frames, 8)).astype(np.uint8)
    payloads = rng.integers(0, 256, (frames, payload_len)).astype(np.uint8)
    iq = gen.assemble(headers, payloads, device="cpu").numpy()
    gap = 400
    n = frames * (gen.frame_len + gap) + 3000
    x = (3e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    for k in range(frames):
        pos = 700 + k * (gen.frame_len + gap)
        x[pos : pos + gen.frame_len] += iq[k]
    return cfg, x, payloads


@pytest.mark.cuda
@needs_card
def test_stream_receiver_v27_on_card_equals_cpu():
    """A v27+v27 stream through ``StreamReceiver.process``: the same frames,
    bytes and flags on the card as on the CPU; the card decodes both codes of
    every frame by the kernel, with no host step."""
    cfg, x, payloads = _v27_tape()
    out = {}
    for dev in ("cpu", "cuda"):
        rx = StreamReceiver(cfg, device=dev)
        before = viterbi_decode_k7.launches
        with profiling.recording() as recs:
            frames = [f for i in range(0, len(x), 5042) for f in rx.process(x[i : i + 5042])]
        counts = {}
        for c in profiling.calls(recs):
            for k, v in c["counts"].items():
                counts[k] = counts.get(k, 0) + v
        out[dev] = (frames, counts, viterbi_decode_k7.launches - before)
    (cpu, cpu_counts, cpu_launches), (card, card_counts, card_launches) = out["cpu"], out["cuda"]
    assert len(card) == len(cpu) == len(payloads)
    assert [bytes(f["payload"]) for f in card] == [bytes(p) for p in payloads]
    for a, b in zip(card, cpu):
        assert a["offset"] == b["offset"] and bytes(a["header"]) == bytes(b["header"])
        assert bytes(a["payload"]) == bytes(b["payload"])
        # flags, geometry and scheme names alike; EVM, RSSI and CFO are float32 sums
        sa, sb = dataclasses.asdict(a["stats"]), dataclasses.asdict(b["stats"])
        assert {k: v for k, v in sa.items() if not isinstance(v, float)} == {
            k: v for k, v in sb.items() if not isinstance(v, float)}
    assert cpu_launches == 0 and "fec.viterbi_kernel_frames" not in cpu_counts
    assert cpu_counts["fec.viterbi_host_steps"] > 0
    # each frame decodes its inner and its outer code once
    assert card_counts["fec.viterbi_kernel_frames"] == 2 * len(card)
    assert "fec.viterbi_host_steps" not in card_counts and card_launches >= 2


# --- on the CPU ---------------------------------------------------------------------


@pytest.mark.parametrize("n_bits", [8, 40, 300])
def test_cpu_takes_the_plain_loop(n_bits):
    """``fec.viterbi_decode`` on a CPU tensor is the plain loop: the same bits
    (and the host decoder's), its host steps counted, no kernel frame and no
    launch."""
    coded = torch.from_numpy(_coded("flipped", (3,), n_bits))
    before = viterbi_decode_k7.launches
    with profiling.recording() as recs:
        with profiling.span("decode"):
            got = fec.viterbi_decode(coded, n_bits)
    assert recs[0]["counts"] == {"fec.viterbi_host_steps": 2 * (n_bits + 6)}
    assert torch.equal(got, viterbi_decode_plain(coded, n_bits))
    for row, c in zip(got.numpy(), coded.numpy()):
        np.testing.assert_array_equal(row, fec.viterbi_decode_bits(c, n_bits))
    assert viterbi_decode_k7.launches == before


@pytest.mark.parametrize(
    "make,in_place",
    [
        (lambda c: c, True),
        (lambda c: c[..., :92], True),  # the first bits of longer rows
        (lambda c: c[1:2, 1, :92].expand(4, 92), True),  # one frame at stride 0
        (lambda c: c[..., ::2], False),  # bits at stride 2
        (lambda c: c.permute(1, 0, 2), False),  # frames at two strides
    ],
)
def test_frames_at_one_stride(make, in_place):
    coded = torch.from_numpy(_coded("random", (2, 3), 40, extra=11))
    assert frames_at_one_stride(make(coded)) is in_place


def test_module_imports_and_decodes_without_nvcc(tmp_path):
    """In a process with no nvcc to be found, ops/viterbi.py imports and the
    CPU decode runs without asking for the kernel library."""
    code = (
        "import torch\n"
        "from cognitive_radio_network_tpu_torch.ops import _build, viterbi\n"
        "from cognitive_radio_network_tpu_torch.phy import fec\n"
        "try:\n"
        "    _build._nvcc()\n"
        "    raise SystemExit('nvcc was found')\n"
        "except RuntimeError:\n"
        "    pass\n"
        "coded = torch.randint(0, 2, (2, 92), dtype=torch.uint8)\n"
        "plain = viterbi.viterbi_decode_plain(coded, 40)\n"
        "assert torch.equal(fec.viterbi_decode(coded, 40), plain)\n"
        "assert fec.decode_bits('v27', coded, 5).shape == (2, 5)\n"
        "assert _build.load.cache_info().currsize == 0\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)  # nothing on it
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1])
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize(
    "what,make,n_bits,match",
    [
        ("dtype", lambda c: c.long(), 40, "uint8"),
        ("short", lambda c: c[:, :91].contiguous(), 40, "92 coded bits"),
        ("strided bits", lambda c: c.repeat(1, 2)[:, ::2], 40, "unit stride"),
        ("frames at two strides", lambda c: c.reshape(2, 2, 92)[:, 1:].expand(2, 2, 92), 40,
         "frames at one stride"),
        ("n_bits", lambda c: c, -1, "bits a frame"),
        ("n_bits", lambda c: c, MAX_BITS + 1, "bits a frame"),
        ("device", lambda c: c, 40, "on a CUDA card, got cpu"),
    ],
)
def test_kernel_wrapper_checks_its_input_without_a_card(what, make, n_bits, match):
    coded = torch.from_numpy(_coded("random", (4,), 40))
    before = viterbi_decode_k7.launches
    with pytest.raises(ValueError, match=match):
        viterbi_decode_k7(make(coded), n_bits)
    assert viterbi_decode_k7.launches == before
