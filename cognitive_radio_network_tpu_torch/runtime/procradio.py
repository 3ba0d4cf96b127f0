"""Third-party radio in a SEPARATE OS process.

Port of ``cognitive_radio_network_tpu/runtime/procradio.py``, with the same
wire format.  The reference supports arbitrary external programs as the
radio by forking ``execvp("python", cognitive_radios/<file>)`` and letting
the child own the node (src/crts_cognitive_radio.cpp:660-720) — the point
being ISOLATION: a buggy user radio cannot take down the node main.  The
in-process plugin path (``cognitive_radio_type="python"``, runtime/control.py)
loads the same ``create_node()`` contract without that isolation; this module
restores it:

* :class:`ProcessRadioNode` is a node-protocol proxy that spawns
  ``python -m cognitive_radio_network_tpu_torch radio-host <file> ...
  --device <device>`` and forwards each simulation step over a framed
  stdin/stdout pipe protocol;
* :func:`run_radio_host` is the child main: it proves its device, loads the
  user file, calls ``create_node(node_id, medium_rate, medium_center, config)``
  — with ``device=`` as well when ``create_node`` takes that keyword
  (``control.create_user_node``) — and services the protocol.  The child's
  real stdout is reserved for the protocol — ``sys.stdout`` is rebound to
  stderr so user ``print`` cannot corrupt the frame stream (the reference
  routes the child's output to the parent tty the same way its sysout
  capture does).

The child runs on the parent's device, which ``--device`` hands down: the
card unless the parent runs on the CPU.  With no card the child raises before
it loads the user file; nothing falls back to the CPU.

Wire format (little-endian): one letter + fixed header + payload.
  parent->child  'S'                                   start()
                 'T' f64 t, u32 n                      poll_traffic(t) +
                                                       pull_tx_block(n)
                 'R' f64 t, u32 n, u32 blen, blen*8 B  push_rx_block /
                                                       push_rx_silence +
                                                       run_ce +
                                                       drain_rx_packets
  child->parent  'S'                                   ack
                 'T' u32 blen, blen*8 B complex64      tx block ('' = None)
                 'R' u32 nrx                           ack + rx packet count

A child crash surfaces as a ConnectionError from the next exchange, which
the scenario runtimes' node-failure isolation catches — the run continues
without the dead radio, like the reference controller surviving a dead
node process.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import subprocess
import sys

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.utils.device import require_device

__all__ = ["ProcessRadioNode", "run_radio_host"]


def _read_exact(f, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        c = f.read(n - len(buf))
        if not c:
            raise ConnectionError("radio-host process closed the pipe")
        buf += c
    return buf


class ProcessRadioNode:
    """Node-protocol proxy for a third-party radio running as its own OS
    process (``cognitive_radio_type="python-process"``) on ``device``."""

    def __init__(
        self,
        node_id: int,
        medium_rate: float,
        medium_center: float,
        nc,
        *,
        device: torch.device | str = "cuda",
    ):
        self.device = require_device(device)
        self.node_id = node_id
        self.started = False
        self.rx_packets: list = []  # protocol parity; child owns real ones
        self._t = 0.0
        env = dict(os.environ)
        for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
            env.setdefault(k, "1")
        self._proc = subprocess.Popen(
            self.argv(node_id, medium_rate, medium_center, nc, self.device),
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=None,  # user radio stderr flows to the node's stderr
            env=env,
        )

    @staticmethod
    def argv(node_id: int, medium_rate: float, medium_center: float, nc, device) -> list[str]:
        """The radio-host child's command line."""
        return [
            sys.executable,
            "-m",
            "cognitive_radio_network_tpu_torch",
            "radio-host",
            nc.python_file,
            "--node-id",
            str(node_id),
            "--medium-rate",
            repr(medium_rate),
            "--medium-center",
            repr(medium_center),
            "--config-json",
            json.dumps(dataclasses.asdict(nc)),
            "--device",
            str(device),
        ]

    # -- protocol helpers ----------------------------------------------

    def _send(self, payload: bytes) -> None:
        try:
            self._proc.stdin.write(payload)
            self._proc.stdin.flush()
        except (BrokenPipeError, OSError) as e:
            raise ConnectionError(
                f"radio-host (node {self.node_id}) died: {e}"
            ) from e

    def _expect(self, tag: bytes) -> None:
        got = _read_exact(self._proc.stdout, 1)
        if got != tag:
            raise ConnectionError(
                f"radio-host (node {self.node_id}) protocol desync: "
                f"expected {tag!r}, got {got!r}"
            )

    # -- node protocol --------------------------------------------------

    def start(self) -> None:
        self._send(b"S")
        self._expect(b"S")
        self.started = True

    def poll_traffic(self, t: float) -> None:
        self._t = t  # folded into the next pull's 'T' exchange

    def pull_tx_block(self, n: int):
        self._send(b"T" + struct.pack("<dI", self._t, n))
        self._expect(b"T")
        (blen,) = struct.unpack("<I", _read_exact(self._proc.stdout, 4))
        if blen == 0:
            return None
        raw = _read_exact(self._proc.stdout, 8 * blen)
        return np.frombuffer(raw, np.complex64).copy()

    def push_rx_block(self, block, t: float, n: int | None = None) -> None:
        if block is None:
            blen, raw = 0, b""
            if n is None:
                raise ValueError("push_rx_block(None) needs the length n")
        else:
            arr = np.ascontiguousarray(block, np.complex64)
            blen, raw, n = len(arr), arr.tobytes(), len(arr)
        self._send(b"R" + struct.pack("<dII", t, int(n), blen) + raw)
        self._expect(b"R")
        _read_exact(self._proc.stdout, 4)  # child-side rx packet count

    def push_rx_silence(self, n: int, t: float) -> None:
        self.push_rx_block(None, t, n)

    def run_ce(self, t: float) -> None:
        pass  # folded into the 'R' exchange child-side

    def drain_rx_packets(self, t: float) -> None:
        pass  # the child owns its packet sink (the reference's child too)

    def close(self) -> None:
        if self._proc.poll() is None:
            try:
                self._proc.stdin.close()  # EOF -> child exits
            except OSError:
                pass
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                try:  # reap: an unkillable-in-time child must not zombify
                    self._proc.wait(timeout=2)
                except subprocess.TimeoutExpired:
                    pass

    def __del__(self):  # last-resort cleanup; runtimes call close()
        try:
            self.close()
        except Exception:
            pass


def run_radio_host(
    python_file: str,
    node_id: int,
    medium_rate: float,
    medium_center: float,
    config_json: str,
    device: torch.device | str = "cuda",
) -> int:
    """Child main (the execvp'd side of the reference's python-radio path,
    src/crts_cognitive_radio.cpp:660-720), its radio on ``device``."""
    from cognitive_radio_network_tpu_torch.runtime.config import NodeConfig
    from cognitive_radio_network_tpu_torch.runtime.control import create_user_node

    device = require_device(device)
    # reserve the REAL stdout for the protocol; user prints go to stderr
    proto_out = os.fdopen(os.dup(1), "wb", buffering=0)
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    nc = NodeConfig(**json.loads(config_json))
    node = create_user_node(node_id, medium_rate, medium_center, nc, device)

    stdin = os.fdopen(os.dup(0), "rb", buffering=0)
    while True:
        tag = stdin.read(1)
        if not tag:  # parent closed the pipe: clean shutdown
            return 0
        if tag == b"S":
            node.start()
            proto_out.write(b"S")
        elif tag == b"T":
            t, n = struct.unpack("<dI", _read_exact(stdin, 12))
            node.poll_traffic(t)
            blk = node.pull_tx_block(n)
            if blk is None:
                proto_out.write(b"T" + struct.pack("<I", 0))
            else:
                arr = np.ascontiguousarray(blk, np.complex64)
                proto_out.write(b"T" + struct.pack("<I", len(arr)) + arr.tobytes())
        elif tag == b"R":
            t, n, blen = struct.unpack("<dII", _read_exact(stdin, 16))
            if blen:
                blk = np.frombuffer(_read_exact(stdin, 8 * blen), np.complex64)
                node.push_rx_block(blk, t)
            elif hasattr(node, "push_rx_silence"):
                node.push_rx_silence(n, t)
            else:
                node.push_rx_block(None, t)
            node.run_ce(t)
            node.drain_rx_packets(t)
            nrx = len(getattr(node, "rx_packets", ()))
            proto_out.write(b"R" + struct.pack("<I", nrx))
        else:
            raise RuntimeError(f"radio-host: unknown message {tag!r}")
