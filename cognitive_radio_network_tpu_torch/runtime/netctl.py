"""Multi-process networked scenario runtime: TCP star topology.

Port of ``cognitive_radio_network_tpu/runtime/netctl.py``, wire-compatible
with it.  The distributed counterpart of the in-process :class:`ScenarioRuntime` —
the same process architecture as the reference (SURVEY.md §2.5): a
controller server listens on ``CRTS_TCP_CONTROL_PORT`` 4444
(include/crts.hpp:190), launches one node *process* per node
(src/crts_controller.cpp:404-421 does it over ssh; here local nodes are
spawned with subprocess, and remote hosts get the same CLI:
``python -m cognitive_radio_network_tpu_torch node -a <controller> -p <port>
--device <device>``),
pushes scenario + node parameters, broadcasts a synchronized start time
(:487-498), exchanges control/feedback during the run, and collects
summaries at termination (src/crts_cognitive_radio.cpp:958-967).

Differences from the reference, by design:

- Messages are explicitly framed ``[u32 len][u8 type][payload]`` with JSON
  bodies instead of raw ``memcpy`` of C structs (layout-coupled, 2-8 KB,
  src/crts_controller.cpp:470-473).  The framing is implemented twice with
  one wire format: natively (native/src/transport.cpp, used when the C++
  library is built) and in pure Python (:class:`PyMsgTransport`), and the
  two interoperate.
- The over-the-air data plane becomes explicit ``TX_BLOCK``/``RX_BLOCK``
  messages through the controller, which hosts the shared :class:`Medium`:
  per simulation step each node contributes its baseband block and receives
  the gain-weighted mix of the others.  Steps are lockstep, so multi-process
  runs are bit-deterministic.

Device: the controller proves its ``device`` before it listens or launches
anything (``require_device``), so a machine with no card fails once, not as
N node tracebacks, and it hands ``--device`` to every node it launches.  A
node process puts its radio's device work there: the card unless the run
asks for the CPU.  N node processes on one card each hold a CUDA context and
share the card by time slices.  The reference's node-side platform pin and
XLA compile cache have no counterpart.  Each node's ``SUMMARY`` also carries
``launches``, the port's kernel launch counters in that process, which the
controller keeps in ``summaries`` and otherwise ignores.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import socket
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

from cognitive_radio_network_tpu_torch import native
from cognitive_radio_network_tpu_torch.runtime.config import NodeConfig, ScenarioConfig
from cognitive_radio_network_tpu_torch.runtime.control import (
    FB_GETTERS,
    apply_node_control,
    build_node,
)
from cognitive_radio_network_tpu_torch.runtime.controller import ScenarioSummary
from cognitive_radio_network_tpu_torch.runtime.engine import create_controller
from cognitive_radio_network_tpu_torch.runtime.logging import LogSink
from cognitive_radio_network_tpu_torch.runtime.medium import Medium, MediumConfig
from cognitive_radio_network_tpu_torch.runtime.node import InterfererNode, RadioNode
from cognitive_radio_network_tpu_torch.runtime.scenario import CrtsParam, Feedback
from cognitive_radio_network_tpu_torch.utils.device import require_device

__all__ = [
    "Msg",
    "CRTS_TCP_CONTROL_PORT",
    "PyMsgTransport",
    "NetController",
    "get_transport",
    "run_node_client",
]

CRTS_TCP_CONTROL_PORT = 4444  # include/crts.hpp:190


class Msg:
    """Message types (enum crts_msg_types, include/crts.hpp:198-205, plus
    the explicit data-plane pair that replaces over-the-air OFDM)."""

    SCENARIO_PARAMETERS = 1
    START = 2
    TERMINATE = 3
    CONTROL = 4
    FEEDBACK = 5
    SUMMARY = 6
    TX_BLOCK = 7  # node -> controller: baseband contribution for one step
    RX_BLOCK = 8  # controller -> node: mixed medium output for one step


class PyMsgTransport:
    """Pure-Python endpoint, wire-compatible with native.MsgTransport."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # medium blocks are ~512 KB messages: with default ~200 KB socket
        # buffers a send blocks mid-message until the (busy) peer drains,
        # serializing the lockstep; size the buffers to hold whole blocks
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            try:
                sock.setsockopt(socket.SOL_SOCKET, opt, 4 << 20)
            except OSError:
                pass

    @staticmethod
    def listen(port: int) -> socket.socket:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("0.0.0.0", port))
        srv.listen(64)
        return srv

    @classmethod
    def accept(cls, server: socket.socket, timeout_ms: int = -1):
        server.settimeout(None if timeout_ms < 0 else timeout_ms / 1e3)
        try:
            conn, _ = server.accept()
        except socket.timeout:
            return None
        return cls(conn)

    @classmethod
    def connect(cls, host: str, port: int, timeout_ms: int = 5000):
        s = socket.create_connection((host, port), timeout=timeout_ms / 1e3)
        s.settimeout(None)
        return cls(s)

    @staticmethod
    def close_server(server: socket.socket) -> None:
        server.close()

    def send(self, msg_type: int, payload: bytes = b"") -> None:
        hdr = struct.pack("<IB", len(payload), msg_type)
        if len(payload) <= 65536:
            self.sock.sendall(hdr + payload)
            return
        # scatter-gather: skip concatenating the ~512 KB block payload
        sent = self.sock.sendmsg([hdr, payload])
        if sent < len(hdr):  # rare: finish the header, then the payload
            self.sock.sendall(hdr[sent:])
            sent = len(hdr)
        mv = memoryview(payload)
        off = sent - len(hdr)
        while off < len(payload):
            off += self.sock.send(mv[off:])

    def send2(self, msg_type: int, head: bytes, arr: np.ndarray) -> None:
        """Framed message with payload head||arr; the array buffer is
        scatter-gathered, never serialized to bytes."""
        arr = np.ascontiguousarray(arr)
        mv = memoryview(arr).cast("B")
        hdr = struct.pack("<IB", len(head) + len(mv), msg_type)
        parts = [hdr, head, mv]
        sent = self.sock.sendmsg(parts)
        total = len(hdr) + len(head) + len(mv)
        while sent < total:  # finish any partial send without concatenating
            off = sent
            rest = []
            for p in parts:
                if off >= len(p):
                    off -= len(p)
                    continue
                rest.append(memoryview(p)[off:] if off else p)
                off = 0
            sent += self.sock.sendmsg(rest)

    def _read_exact(self, n: int, first_timeout_ms: int) -> bytes | None:
        chunks = b""
        self.sock.settimeout(None if first_timeout_ms < 0 else first_timeout_ms / 1e3)
        while len(chunks) < n:
            try:
                c = self.sock.recv(n - len(chunks))
            except socket.timeout:
                if not chunks:
                    return None
                raise ConnectionError("timeout mid-frame")
            if not c:
                if not chunks and n > 0:
                    raise ConnectionResetError("peer closed")
                raise ConnectionError("peer closed mid-frame")
            chunks += c
            self.sock.settimeout(None)
        return chunks

    def recv(self, timeout_ms: int = -1) -> tuple[int, bytes] | None:
        hdr = self._read_exact(5, timeout_ms)
        if hdr is None:
            return None
        length, typ = struct.unpack("<IB", hdr)
        payload = self._read_exact(length, -1) if length else b""
        return typ, payload

    def close(self) -> None:
        self.sock.close()


def get_transport(kind: str = "auto"):
    """Select the transport implementation: 'native', 'python', or 'auto'."""
    if kind == "python":
        return PyMsgTransport
    if kind == "native" or (kind == "auto" and native.available()):
        return native.MsgTransport
    return PyMsgTransport


def _pack_block(step: int, block: np.ndarray | None) -> bytes:
    hdr = struct.pack("<I", step)
    if block is None:
        return hdr
    return hdr + np.ascontiguousarray(block, np.complex64).tobytes()


def _send_block(conn, msg_type: int, step: int, block: np.ndarray | None) -> None:
    """Send a TX/RX_BLOCK (``_pack_block``'s layout), scatter-gathering the
    sample buffer: both transports have ``send2``."""
    if block is None:
        conn.send(msg_type, _pack_block(step, None))
    else:
        conn.send2(msg_type, struct.pack("<I", step), np.ascontiguousarray(block, np.complex64))


def _unpack_block(payload: bytes) -> tuple[int, np.ndarray | None]:
    (step,) = struct.unpack_from("<I", payload)
    if len(payload) == 4:
        return step, None
    # frombuffer with offset: no second copy of the ~0.5 MB payload
    return step, np.frombuffer(payload, np.complex64, offset=4)


def _json(obj: Any) -> bytes:
    return json.dumps(obj).encode()


def _fit_recv_cap(conn, block_len: int) -> None:
    """Grow the native transport's receive cap to fit a TX/RX_BLOCK payload
    (4-byte step header + block_len complex64); PyMsgTransport is unbounded."""
    if hasattr(conn, "set_recv_cap"):
        conn.set_recv_cap(4 + 8 * int(block_len) + 4096)


class NetController:
    """Controller process: scenario server + medium hub.

    ``launch='local'`` spawns node client subprocesses; ``launch='ssh'``
    launches each node on its configured ``server_ip`` as
    ``server_user`` over ssh, capturing its stdout under
    ``sysout_dir`` and force-killing the exact remote PID on abnormal
    termination (the reference's automated remote launch + kill,
    src/crts_controller.cpp:404-421, :567-577); ``launch='manual'``
    only listens (the reference's ``-m`` manual mode,
    src/crts_controller.cpp:221, where operators start nodes by hand —
    possibly on other hosts pointing ``-a`` at this controller).

    ``ssh_cmd`` is the ssh argv prefix (host and remote command are
    appended); ``controller_addr`` is the address remote nodes dial back
    to (the reference passes its autodetected eth0 IP via ``-a``,
    src/crts_controller.cpp:191-204); ``remote_python`` names the
    interpreter on the remote hosts.  ``device`` is where every node
    process runs its device work (the card unless asked for the CPU); it is
    proved here, before anything is launched.
    """

    def __init__(
        self,
        cfg: ScenarioConfig,
        *,
        port: int = CRTS_TCP_CONTROL_PORT,
        transport: str = "auto",
        launch: str = "local",
        start_pad_s: float = 0.25,
        log_sink: LogSink | None = None,
        ssh_cmd: list[str] | None = None,
        controller_addr: str = "127.0.0.1",
        remote_python: str = "python3",
        sysout_dir: str = "logs/sysout",
        accept_timeout_s: float | None = None,
        device: torch.device | str = "cuda",
    ):
        self.device = require_device(device)
        self.cfg = cfg
        self.port = port
        self.tcls = get_transport(transport)
        self.transport_kind = transport
        self.launch = launch
        self.start_pad_s = start_pad_s
        self.log = log_sink or LogSink()
        self.mcfg = MediumConfig(
            sample_rate_hz=cfg.medium_rate,
            center_hz=cfg.medium_center,
            block_len=cfg.medium_block_len,
            noise_power=cfg.medium_noise_power,
            seed=cfg.seed,
        )
        self.medium = Medium(self.mcfg, len(cfg.nodes))
        self.sc = create_controller(
            cfg.scenario_controller, cfg.sc_args.split() if cfg.sc_args else []
        )
        self.sc.runtime = self
        self.sc.sc_timeout_ms = cfg.sc_timeout_ms
        self.conns: list[Any] = []
        self.procs: list[subprocess.Popen] = []
        self.t = 0.0
        self.summaries: dict[int, dict] = {}
        self.terminated = False
        self.ssh_cmd = ssh_cmd or ["ssh", "-o", "BatchMode=yes"]
        self.controller_addr = controller_addr
        self.remote_python = remote_python
        self.sysout_dir = sysout_dir
        self._sysout_files: list[Any] = []  # (node idx, path) for ssh launch
        self._stderr_files: list[Any] = []  # (node idx, tempfile)
        self._ssh_hosts: list[str] = []
        # N simultaneously-launched node processes import their runtime
        # before dialing in; the accept window must scale with the launch
        # storm (48 processes on a small host take minutes to all arrive)
        self.accept_timeout_s = (
            accept_timeout_s
            if accept_timeout_s is not None
            else 30.0 + 4.0 * len(cfg.nodes)
        )

    # SC control channel (set_node_parameter -> CRTS_MSG_CONTROL,
    # src/scenario_controller.cpp:13-28)
    def apply_control(self, node_idx: int, param: CrtsParam, value) -> None:
        if param is CrtsParam.FB_EN:
            self.sc.enable_feedback(node_idx, int(value))
        self.conns[node_idx].send(
            Msg.CONTROL, _json({"param": param.value, "value": value})
        )

    def _node_args(self, addr: str) -> list[str]:
        """The node client's arguments after the interpreter."""
        return [
            "-m",
            "cognitive_radio_network_tpu_torch",
            "node",
            "-a",
            addr,
            "-p",
            str(self.port),
            "--transport",
            self.transport_kind,
            "--device",
            str(self.device),
        ]

    def _node_argv(self, addr: str) -> list[str]:
        return [sys.executable, *self._node_args(addr)]

    def _remote_command(self) -> str:
        """The ssh remote shell command: print the PID, then ``exec`` the
        node client under it (see :meth:`_launch_nodes_ssh`)."""
        args = " ".join(self._node_args(self.controller_addr))
        return f"echo CRN_NODE_PID $$; exec {self.remote_python} {args}"

    @staticmethod
    def _node_env() -> dict:
        """Node-process environment: one BLAS/OpenMP thread per node — N
        node processes each spawning a thread pool oversubscribe the host
        (the reference's node binaries are single-threaded per function
        for the same reason)."""
        env = dict(os.environ)
        for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
            env.setdefault(k, "1")
        return env

    def _stderr_file(self, i: int):
        """Per-node stderr capture FILE — a PIPE nobody drains deadlocks
        the node once 64 KB of warnings accumulate."""
        f = tempfile.NamedTemporaryFile(
            mode="w+b", prefix=f"crn_node{i}_", suffix=".stderr", delete=False
        )
        self._stderr_files.append((i, f))
        return f

    def _launch_nodes(self) -> None:
        if self.launch == "ssh":
            self._launch_nodes_ssh()
            return
        if self.launch != "local":
            return
        env = self._node_env()
        for i in range(len(self.cfg.nodes)):
            self.procs.append(
                subprocess.Popen(
                    self._node_argv("127.0.0.1"),
                    stdout=subprocess.DEVNULL,
                    stderr=self._stderr_file(i),
                    env=env,
                )
            )

    def _launch_nodes_ssh(self) -> None:
        """One ssh-launched node process per node on its ``server_ip``
        (src/crts_controller.cpp:404-421).  The remote shell first prints
        its PID and then ``exec``s the node client (same PID), so the
        sysout capture doubles as the exact-PID record for remote
        forceful kill — the reference resorted to a remote pkill-by-name
        script (src/terminate_crts_cognitive_radio.py)."""
        out_dir = Path(self.sysout_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for i, nc in enumerate(self.cfg.nodes):
            host = nc.server_ip
            target = f"{nc.server_user}@{host}" if nc.server_user else host
            remote = self._remote_command()
            out_path = out_dir / f"{self.cfg.name}_node{i}.log"
            out_f = open(out_path, "wb")
            self._sysout_files.append((i, out_path, out_f))
            self._ssh_hosts.append(target)
            self.procs.append(
                subprocess.Popen(
                    [*self.ssh_cmd, target, remote],
                    stdout=out_f,
                    stderr=self._stderr_file(i),
                )
            )

    def _remote_pid(self, i: int) -> int | None:
        """Parse the CRN_NODE_PID line from node i's sysout capture."""
        for j, path, _f in self._sysout_files:
            if j != i:
                continue
            try:
                for line in path.read_bytes().splitlines():
                    if line.startswith(b"CRN_NODE_PID "):
                        return int(line.split()[1])
            except (OSError, ValueError):
                return None
        return None

    def _ssh_kill(self, i: int) -> None:
        """Forceful remote termination of node i's EXACT pid
        (the reference's ssh kill -9, src/crts_controller.cpp:567-577)."""
        pid = self._remote_pid(i)
        if pid is None or i >= len(self._ssh_hosts):
            return
        try:
            subprocess.run(
                [*self.ssh_cmd, self._ssh_hosts[i], f"kill -9 {pid}"],
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                timeout=15,
                check=False,
            )
        except (subprocess.TimeoutExpired, OSError):
            # cleanup path (finally): an unreachable/hung remote must not
            # abort the kill loop for the remaining nodes or mask the
            # original error
            pass

    def _handle_feedback(self, payload: bytes) -> None:
        d = json.loads(payload)
        self.sc.receive_feedback(
            Feedback(d["node"], CrtsParam(d["param"]), d["value"], d["time_s"])
        )

    def _node_stderr_tail(self) -> str:
        """Diagnostics from dead node processes (failure detection — the
        reference controller notices disconnects, src/crts_controller.cpp:43-54,
        but discards the remote stderr; we surface it)."""
        out = []
        files = dict((i, f) for i, f in self._stderr_files)
        for i, p in enumerate(self.procs):
            try:  # give a dying process a moment to flush and exit
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                continue
            f = files.get(i)
            if f is None:
                continue
            try:
                f.flush()
                f.seek(0)
                tail = f.read().decode(errors="replace")[-2000:]
            except (OSError, ValueError):
                continue
            if tail.strip():
                out.append(f"--- node {i} (rc={p.returncode}) stderr ---\n{tail}")
        return "\n".join(out)

    def run(self, rep: int = 1) -> ScenarioSummary:
        cfg = self.cfg
        send_pool = None  # created once the node count is known
        srv = self.tcls.listen(self.port)
        try:
            self._launch_nodes()
            # accept + parameter push (src/crts_controller.cpp:430-473)
            for i in range(len(cfg.nodes)):
                conn = self.tcls.accept(srv, int(self.accept_timeout_s * 1e3))
                if conn is None:
                    raise TimeoutError(
                        f"node {i} did not connect\n" + self._node_stderr_tail()
                    )
                _fit_recv_cap(conn, cfg.medium_block_len)
                self.conns.append(conn)
            scenario_d = dataclasses.asdict(cfg)
            for i, conn in enumerate(self.conns):
                conn.send(
                    Msg.SCENARIO_PARAMETERS,
                    _json({"node_index": i, "scenario": scenario_d}),
                )
            self.sc.initialize_node_fb()
            # synchronized start (start_time_s = now + pad, :487-509)
            start_time = time.time() + self.start_pad_s
            for conn in self.conns:
                conn.send(Msg.START, _json({"start_time": start_time}))
            while time.time() < start_time:
                time.sleep(0.001)
            # lockstep main loop: one medium block per step; step count
            # matches ScenarioRuntime's `while t < run_time` semantics
            num_steps = math.ceil(cfg.run_time / self.mcfg.block_dt - 1e-9)
            # rx blocks go out on a pool: each ~0.5 MB send is a kernel-
            # buffer memcpy on its own fd, so N sends cost max() not sum()
            if len(self.conns) > 1:
                send_pool = ThreadPoolExecutor(min(len(self.conns), 8))
            last_sc_t = 0.0
            wall_start = time.monotonic()
            # steady-state window: from a quarter into the run (node
            # processes fill their caches, build their FFT plans and load
            # the kernels over the first steps)
            k0 = max(num_steps // 4, 1)
            wall_k0 = None
            t_k0 = 0.0
            for step in range(num_steps):
                if self.terminated:
                    break
                if step == k0:
                    wall_k0 = time.monotonic()
                    t_k0 = self.t
                step_ms = int(cfg.net_step_timeout_s * 1e3)
                contributions: list[np.ndarray | None] = [None] * len(self.conns)
                for i, conn in enumerate(self.conns):
                    while True:
                        try:
                            typ, payload = conn.recv(step_ms) or (None, b"")
                        except (ConnectionError, OSError) as e:
                            raise ConnectionError(
                                f"node {i} died at step {step}: {e}\n"
                                + self._node_stderr_tail()
                            ) from e
                        if typ is None:
                            raise TimeoutError(
                                f"node {i} stalled at step {step}\n"
                                + self._node_stderr_tail()
                            )
                        if typ == Msg.TX_BLOCK:
                            got_step, block = _unpack_block(payload)
                            assert got_step == step, (got_step, step)
                            contributions[i] = block
                            break
                        if typ == Msg.FEEDBACK:
                            self._handle_feedback(payload)
                        elif typ == Msg.TERMINATE:  # node-initiated abort
                            self.terminated = True
                            break
                if self.terminated:
                    break
                blocks = self.medium.propagate(contributions)
                if send_pool is not None:
                    list(
                        send_pool.map(
                            lambda cb, s=step: _send_block(
                                cb[0], Msg.RX_BLOCK, s, cb[1]
                            ),
                            zip(self.conns, blocks),
                        )
                    )
                else:
                    for conn, block in zip(self.conns, blocks):
                        _send_block(conn, Msg.RX_BLOCK, step, block)
                self.t += self.mcfg.block_dt
                if (self.t - last_sc_t) * 1e3 >= self.sc.sc_timeout_ms:
                    self.sc.timeout()
                    last_sc_t = self.t
                if (
                    cfg.max_wall_time_s is not None
                    and time.monotonic() - wall_start > cfg.max_wall_time_s
                ):
                    self.terminated = True
            # wall-clock accounting for realtime-factor benchmarks: the
            # full lockstep loop, plus the steady-state window above
            self.wall_time_s = time.monotonic() - wall_start
            self.steady_wall_time_s = (
                time.monotonic() - wall_k0 if wall_k0 is not None else 0.0
            )
            self.steady_t = max(self.t - t_k0, 0.0) if wall_k0 is not None else 0.0
            # termination + summary collection (:958-967 node side)
            for conn in self.conns:
                try:
                    conn.send(Msg.TERMINATE)
                except (ConnectionError, OSError):
                    pass  # node already finished and sent its summary
            # summary deadline scales with the fleet: at 48 processes the
            # post-terminate drain (final rx processing + summary send)
            # contends for the host's cores
            summary_wait = 30.0 + 2.0 * len(self.conns)
            for i, conn in enumerate(self.conns):
                deadline = time.time() + summary_wait
                while i not in self.summaries and time.time() < deadline:
                    try:
                        msg = conn.recv(5000)
                    except (ConnectionError, OSError):
                        break
                    if msg is None:
                        continue
                    typ, payload = msg
                    if typ == Msg.SUMMARY:
                        self.summaries[i] = json.loads(payload)
                    elif typ == Msg.FEEDBACK:
                        self._handle_feedback(payload)
        finally:
            if send_pool is not None:
                send_pool.shutdown(wait=False)
            self.log.flush()  # persist spill logs even on abnormal exit
            for conn in self.conns:
                try:
                    conn.close()
                except Exception:
                    pass
            self.tcls.close_server(srv)
            # forceful termination of the exact PIDs we spawned
            # (the reference's ssh kill -9, src/crts_controller.cpp:567-577)
            for i, p in enumerate(self.procs):
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    if self.launch == "ssh":
                        self._ssh_kill(i)  # exact remote PID first
                        try:
                            p.wait(timeout=5)
                        except subprocess.TimeoutExpired:
                            p.kill()
                    else:
                        p.kill()
            for _i, _path, f in self._sysout_files:
                try:
                    f.close()
                except OSError:
                    pass
            for _i, f in self._stderr_files:
                try:
                    f.close()
                    os.unlink(f.name)
                except OSError:
                    pass
        n = len(cfg.nodes)
        empty = {"bytes_sent": 0, "bytes_received": 0, "frames": 0, "valid": 0}
        s = [self.summaries.get(i, empty) for i in range(n)]
        return ScenarioSummary(
            cfg.name,
            rep,
            [x["bytes_sent"] for x in s],
            [x["bytes_received"] for x in s],
            [x["frames"] for x in s],
            [x["valid"] for x in s],
        )


def run_node_client(
    host: str,
    port: int = CRTS_TCP_CONTROL_PORT,
    transport: str = "auto",
    device: torch.device | str = "cuda",
) -> int:
    """Node process main (src/crts_cognitive_radio.cpp:507-968 /
    src/crts_interferer.cpp:314-420 merged: the node type comes from the
    pushed config), its device work on ``device``: the card unless asked
    for the CPU; with no card it raises before it dials the controller.

    Set ``CRN_NODE_PROFILE=/path/prefix`` to cProfile the node loop; stats
    are dumped to ``<prefix><node_index>.pstats`` on exit (profiling the
    reference's node processes needed gdb; here it is one env var)."""
    device = require_device(device)
    prof_prefix = os.environ.get("CRN_NODE_PROFILE")
    if prof_prefix:
        import cProfile

        prof = cProfile.Profile()
        prof.enable()
        try:
            return _run_node_client_inner(host, port, transport, device)
        finally:
            prof.disable()
            idx = getattr(_run_node_client_inner, "last_index", "x")
            prof.dump_stats(f"{prof_prefix}{idx}.pstats")
    return _run_node_client_inner(host, port, transport, device)


def _kernel_launches() -> dict[str, int]:
    """The port's kernel launch counters in this process."""
    from cognitive_radio_network_tpu_torch import ops

    return {
        fn.__name__: fn.launches
        for fn in (
            ops.fused_sense_ct,
            ops.extract_windows,
            ops.wideband_energy_fused,
            ops.fused_band_features,
            ops.resolve_candidates,
        )
    }


def _run_node_client_inner(
    host: str, port: int, transport: str, device: torch.device
) -> int:
    tcls = get_transport(transport)
    conn = tcls.connect(host, port, 30000)
    try:
        typ, payload = conn.recv(30000) or (None, b"")
        if typ != Msg.SCENARIO_PARAMETERS:
            raise RuntimeError(f"expected SCENARIO_PARAMETERS, got {typ}")
        d = json.loads(payload)
        idx = d["node_index"]
        _run_node_client_inner.last_index = idx
        cfg = _scenario_from_asdict(d["scenario"])
        _fit_recv_cap(conn, cfg.medium_block_len)
        mcfg = MediumConfig(
            sample_rate_hz=cfg.medium_rate,
            center_hz=cfg.medium_center,
            block_len=cfg.medium_block_len,
            noise_power=cfg.medium_noise_power,
            seed=cfg.seed,
        )
        sink = LogSink()
        node = build_node(idx, cfg.nodes[idx], mcfg, sink, device=device)
        fb_mask = 0
        last_fb: dict[CrtsParam, Any] = {}
        last_stats_t = -1e9

        def on_fb_en(mask: int) -> None:
            nonlocal fb_mask
            fb_mask = mask

        # wait for synchronized start, servicing control msgs meanwhile
        # (the reference busy-waits on wall clock while still applying
        # controls, src/crts_cognitive_radio.cpp:793-805)
        while True:
            typ, payload = conn.recv(60000) or (None, b"")
            if typ == Msg.START:
                break
            if typ == Msg.CONTROL:
                c = json.loads(payload)
                apply_node_control(
                    node, CrtsParam(c["param"]), c["value"], on_fb_en=on_fb_en
                )
            elif typ == Msg.TERMINATE:
                return 0
            else:
                raise RuntimeError(f"expected START, got {typ}")
        start_time = json.loads(payload)["start_time"]
        while time.time() < start_time:
            time.sleep(0.001)
        node.start()

        def send_feedback(t: float) -> None:
            nonlocal last_stats_t
            if isinstance(node, InterfererNode) or not hasattr(node, "radio"):
                return
            for param, getter in FB_GETTERS.items():
                if not (fb_mask >> param.value) & 1:
                    continue
                val = getter(node.radio)
                if last_fb.get(param) != val:
                    last_fb[param] = val
                    conn.send(
                        Msg.FEEDBACK,
                        _json(
                            {"node": idx, "param": param.value, "value": val, "time_s": t}
                        ),
                    )
            if (fb_mask >> CrtsParam.RX_STATS.value) & 1:
                period = node.radio.rx_stat_fb_period_s or 1.0
                if t - last_stats_t >= period:
                    last_stats_t = t
                    stats = dataclasses.asdict(node.radio.get_rx_stats(t))
                    conn.send(
                        Msg.FEEDBACK,
                        _json(
                            {
                                "node": idx,
                                "param": CrtsParam.RX_STATS.value,
                                "value": stats,
                                "time_s": t,
                            }
                        ),
                    )

        t = 0.0
        step = 0
        terminated = False
        # same step count as the controller (and as ScenarioRuntime's
        # `while t < run_time`), so traffic accounting is identical
        num_steps = math.ceil(cfg.run_time / mcfg.block_dt - 1e-9)
        # steady-window CPU accounting (same quarter-run window as the
        # controller's steady wall clock)
        cpu_k0_step = max(num_steps // 4, 1)
        cpu_t0 = time.process_time()
        cpu_sim_t0 = 0.0

        # Pipelined lockstep (ScenarioConfig.net_pipeline): the serial loop
        # is [produce tx N -> send -> wait -> process rx N] with every stage
        # on the critical path.  Here the node mirrors the reference's own
        # thread structure (tx worker / CE thread,
        # src/extensible_cognitive_radio.cpp:1643-1758 / :1761-1808):
        #
        #   send TX N  ->  process RX N-1   ->  submit produce TX N+1
        #                                   ->  recv RX N (the producer
        #                                       overlaps this wait, i.e. the
        #                                       controller's gather +
        #                                       propagate + send for step N)
        #
        # so per step the wall cost is max(node work, controller work)
        # instead of their sum.  Consistency discipline: the reference
        # stages CE parameter updates in tx_params_updated and copies the
        # whole struct under tx_params_mutex between frames
        # (update_tx_params, src/extensible_cognitive_radio.cpp:829-881),
        # so its tx worker never sees a torn multi-param config.  The
        # equivalent here is SERIALIZATION, not locking: produce() is
        # submitted only AFTER process_rx (where CE engines run) and is
        # joined before any CRTS_MSG_CONTROL is applied (see the recv
        # loop), so every frame is assembled from a settled parameter set
        # and runs are bit-reproducible.  Semantics vs the serial loop: a
        # CE/control tx-param change reaches the air up to two blocks
        # (~2*block_dt) later, and rx-driven CE decisions act one block
        # later — the same latencies a physical radio has between a CE
        # retune and the first frame transmitted with it.
        # net_pipeline=false restores the bit-identical serial loop.
        executor = None
        if getattr(cfg, "net_pipeline", True):
            executor = ThreadPoolExecutor(1)

        def produce(tt: float):
            node.poll_traffic(tt)
            return node.pull_tx_block(mcfg.block_len)

        def process_rx(block, tt: float) -> None:
            if block is not None:
                node.push_rx_block(block, tt)
            elif hasattr(node, "push_rx_silence"):
                node.push_rx_silence(mcfg.block_len, tt)
            node.run_ce(tt)
            node.drain_rx_packets(tt)
            send_feedback(tt)

        # `pending` wraps the speculative block in a 1-tuple: a silent
        # block is a legitimate (None) production — treating bare None as
        # "no speculation" re-ran produce() and double-advanced the node's
        # sample cursors on every silent block (interferer duty/dwell
        # timelines ran 2x, tx mixer phase jumped)
        pending: tuple | None = None
        prev = None  # (rx block, t) received last step, not yet processed
        try:
            while not terminated and step < num_steps:
                if step == cpu_k0_step:
                    cpu_t0 = time.process_time()
                    cpu_sim_t0 = t
                contribution = pending[0] if pending is not None else produce(t)
                pending = None
                _send_block(conn, Msg.TX_BLOCK, step, contribution)
                if prev is not None:
                    # overlaps the controller's work on THIS step
                    process_rx(*prev)
                    prev = None
                # speculative produce for step N+1, submitted only after
                # process_rx so the producer sees a settled post-CE state —
                # it overlaps the recv wait below (the controller's gather +
                # propagate + send), which is the long pole it must hide
                fut = (
                    executor.submit(produce, t + mcfg.block_dt)
                    if executor is not None and step + 1 < num_steps
                    else None
                )
                while True:
                    msg = conn.recv(int(cfg.net_step_timeout_s * 1e3))
                    if msg is None:
                        raise TimeoutError(f"controller stalled at step {step}")
                    typ, payload = msg
                    if typ == Msg.RX_BLOCK:
                        _, block = _unpack_block(payload)
                        break
                    if typ == Msg.CONTROL:
                        # join the speculative produce FIRST: a control
                        # write racing the producer could yield a torn
                        # frame (resampled at the old tx_rate, mixed at
                        # the new tx_freq); joined-then-applied, the
                        # control deterministically reaches the air one
                        # block later
                        if fut is not None:
                            pending = (fut.result(),)
                            fut = None
                        c = json.loads(payload)
                        apply_node_control(
                            node, CrtsParam(c["param"]), c["value"], on_fb_en=on_fb_en
                        )
                    elif typ == Msg.TERMINATE:
                        terminated = True
                        block = None
                        break
                if fut is not None:
                    # join before the next iteration touches tx state
                    pending = (fut.result(),)
                if terminated:
                    break
                if executor is None:
                    process_rx(block, t)  # serial loop: process in place
                else:
                    prev = (block, t)
                t += mcfg.block_dt
                step += 1
            if prev is not None:
                process_rx(*prev)  # drain the one-step pipeline
            fin = getattr(node, "finalize", None)
            if callable(fin):  # flush the batched rx scan's tail frames
                fin(t)
        finally:
            if executor is not None:
                executor.shutdown(wait=True)
        # end-of-run summary (CRTS_MSG_SUMMARY, :958-967); cpu_time_s is
        # this process's CPU cost of the lockstep loop's steady window
        # (imports and node construction excluded) — the controller uses it
        # to report the per-node real-time margin under the reference's
        # one-host-per-node deployment model.  On the card it also counts
        # the CUDA driver's threads and its spin-waits on reads
        cpu_time_s = time.process_time() - cpu_t0
        if isinstance(node, RadioNode):
            sent = node.traffic.packet_num * 256
            rcvd = sum(len(p) for (_, _, p) in node.rx_packets)
            st = node.radio.stats
            summary = {
                "bytes_sent": sent,
                "bytes_received": rcvd,
                "frames": len(st.records),
                "valid": sum(1 for r in st.records if r.valid),
                "cpu_time_s": cpu_time_s,
                "sim_time_s": t - cpu_sim_t0,
                "tx_samples": int(node.radio._tx_sample_cursor),
                "launches": _kernel_launches(),
            }
        else:
            summary = {
                "bytes_sent": 0,
                "bytes_received": 0,
                "frames": 0,
                "valid": 0,
                "cpu_time_s": cpu_time_s,
                "sim_time_s": t - cpu_sim_t0,
                "tx_samples": int(getattr(node, "_cursor", 0)),
                "launches": _kernel_launches(),
            }
        conn.send(Msg.SUMMARY, _json(summary))
        return 0
    finally:
        if "node" in locals():  # e.g. ProcessRadioNode child reaping
            closer = getattr(node, "close", None)
            if callable(closer):
                try:
                    closer()
                except Exception:
                    pass
        conn.close()


def _scenario_from_asdict(d: dict) -> ScenarioConfig:
    """Rebuild a ScenarioConfig from dataclasses.asdict output."""
    nodes = [NodeConfig(**nd) for nd in d.pop("nodes")]
    cfg = ScenarioConfig(**d)
    cfg.nodes = nodes
    return cfg
