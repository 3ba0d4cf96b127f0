"""Host ms per ``StreamReceiver.process`` call spent inside the FEC decode
(``phy/fec.py::decode_bits``, which runs ``viterbi_decode`` for v27): the
harness wraps the module attribute that ``phy/framesync.py`` calls.  Read
from the spans of the untraced window, so the profiler's cost is left out."""


def read(rec):
    calls = sum(1 for name, _t0, _t1 in rec["spans"] if name == "process")
    if not calls:
        return None
    return sum(t1 - t0 for name, t0, t1 in rec["spans"] if name == "decode_bits") / calls * 1e3
