"""Network traffic generators: stream / burst / poisson.

Port of the UDP traffic loop of src/crts_cognitive_radio.cpp:826-879: packets
of CRTS_CR_PACKET_LEN=256 bytes whose payload is the degree-12 m-sequence
with a masked 4-byte packet number up front (:750-764, include/crts.hpp:192-194),
paced to a mean throughput with three inter-arrival models
(enum net_traffic_type, include/crts.hpp:72-77).

Port of ``cognitive_radio_network_tpu/runtime/traffic.py``, copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cognitive_radio_network_tpu_torch.signal.msequence import msequence_bytes

__all__ = ["TrafficConfig", "TrafficSource", "PACKET_LEN", "PACKET_NUM_LEN"]

PACKET_LEN = 256  # CRTS_CR_PACKET_LEN
PACKET_NUM_LEN = 4  # CRTS_CR_PACKET_NUM_LEN


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    traffic_type: str = "stream"  # stream | burst | poisson
    mean_throughput_bps: float = 1e6
    burst_length: int = 1  # packets per burst (burst mode)


class TrafficSource:
    """Produces (timestamp, packet) pairs in simulation time.

    The packet body is the fixed m-sequence; bytes 0..3 are overwritten with
    the packet number, each byte masked so it can't collide with framing
    (the reference ORs marker bits, src/crts_cognitive_radio.cpp:757-763 —
    here the number is stored little-endian over 4 raw bytes).
    """

    def __init__(self, cfg: TrafficConfig, seed: int = 0):
        self.cfg = cfg
        self.base_payload = msequence_bytes(PACKET_LEN)
        self.packet_num = 0
        self.rng = np.random.default_rng(seed)
        self._next_t = 0.0
        bits_per_packet = PACKET_LEN * 8
        self.mean_interval = bits_per_packet / cfg.mean_throughput_bps

    def _make_packet(self) -> np.ndarray:
        p = self.base_payload.copy()
        num = np.frombuffer(
            int(self.packet_num).to_bytes(PACKET_NUM_LEN, "little"), np.uint8
        )
        p[:PACKET_NUM_LEN] = num
        self.packet_num += 1
        return p

    def packets_until(self, t: float) -> list[tuple[float, np.ndarray]]:
        """All packets scheduled up to simulation time t."""
        out: list[tuple[float, np.ndarray]] = []
        cfg = self.cfg
        while self._next_t <= t:
            if cfg.traffic_type == "stream":
                out.append((self._next_t, self._make_packet()))
                self._next_t += self.mean_interval
            elif cfg.traffic_type == "burst":
                for _ in range(max(cfg.burst_length, 1)):
                    out.append((self._next_t, self._make_packet()))
                self._next_t += self.mean_interval * max(cfg.burst_length, 1)
            elif cfg.traffic_type == "poisson":
                out.append((self._next_t, self._make_packet()))
                self._next_t += float(self.rng.exponential(self.mean_interval))
            else:
                raise ValueError(f"unknown traffic type {cfg.traffic_type!r}")
        return out

    @staticmethod
    def packet_number(payload: np.ndarray) -> int:
        return int.from_bytes(bytes(payload[:PACKET_NUM_LEN]), "little")


class UdpBridge:
    """Real-application data plane over UDP sockets.

    The capability class of the reference's per-node kernel networking —
    a TUN device fed by real UDP sockets so arbitrary programs ride the
    radio link (src/tun.cpp:31-89; src/crts_cognitive_radio.cpp:722-915)
    — without the TUN device or root: any real program sends datagrams to
    the node's INGRESS port and they are carried over the link as
    packets; decoded DATA payloads are forwarded as datagrams to the
    configured EGRESS endpoint (the "application" side).  Enable with
    ``net_traffic_type = "udp"`` plus ``udp_listen_port`` /
    ``udp_forward_addr`` / ``udp_forward_port`` in the node config.
    """

    # max UDP datagram (~65507 B payload): recv with a smaller buffer
    # silently TRUNCATES a datagram on a SOCK_DGRAM socket.  The PHY
    # header's payload_len field is 16-bit, so any full datagram can
    # ride the link as one frame.
    MAX_DGRAM = 65536

    def __init__(
        self,
        listen_port: int = 0,
        forward_addr: str = "127.0.0.1",
        forward_port: int = 0,
    ):
        import socket

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("0.0.0.0", int(listen_port)))
        self.sock.setblocking(False)
        self.listen_port = self.sock.getsockname()[1]  # 0 -> ephemeral
        self.forward = (forward_addr, int(forward_port))
        self.bytes_in = 0
        self.bytes_out = 0

    def poll(self, limit: int = 256) -> list[np.ndarray]:
        """Drain pending ingress datagrams (non-blocking) as packets."""
        out: list[np.ndarray] = []
        for _ in range(limit):
            try:
                data = self.sock.recv(self.MAX_DGRAM)
            except BlockingIOError:
                break
            except OSError:
                break
            if data:
                self.bytes_in += len(data)
                out.append(np.frombuffer(data, np.uint8).copy())
        return out

    def forward_payload(self, payload: np.ndarray) -> None:
        """Decoded link payload -> application datagram (the TUN write
        side, src/extensible_cognitive_radio.cpp:1441-1450)."""
        if not self.forward[1]:
            return
        try:
            self.sock.sendto(bytes(payload), self.forward)
            self.bytes_out += len(payload)
        except OSError:
            pass  # application endpoint gone: drop, like an unread TUN

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
