"""Shared node construction + control/feedback parameter application.

Port of ``cognitive_radio_network_tpu/runtime/control.py``, used by the
in-process :class:`ScenarioRuntime` (runtime/controller.py); the reference's
multi-process networked runtime (runtime/netctl.py) and third-party radios
in their own process (runtime/procradio.py) are not ported yet.  The control
mapping is the node side's ``apply_control_msg`` (src/crts_cognitive_radio.cpp:127-206,
src/crts_interferer.cpp:314-420); the feedback getters are the node side's
delta-detection sources (src/crts_cognitive_radio.cpp:208-383).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from cognitive_radio_network_tpu_torch.env.interference import InterfererConfig
from cognitive_radio_network_tpu_torch.phy import subcarriers as sc_mod
from cognitive_radio_network_tpu_torch.runtime.config import NodeConfig
from cognitive_radio_network_tpu_torch.runtime.medium import MediumConfig
from cognitive_radio_network_tpu_torch.runtime.node import InterfererNode, RadioNode
from cognitive_radio_network_tpu_torch.runtime.scenario import CrtsParam
from cognitive_radio_network_tpu_torch.runtime.traffic import TrafficConfig

__all__ = ["build_node", "apply_node_control", "FB_GETTERS"]


def _alloc_for(node: NodeConfig, side: str):
    method = getattr(node, f"{side}_subcarrier_alloc_method")
    m = getattr(node, f"{side}_subcarriers")
    if method == "standard":
        return tuple(
            sc_mod.standard_alloc(
                m,
                getattr(node, f"{side}_guard_subcarriers"),
                getattr(node, f"{side}_central_nulls"),
                getattr(node, f"{side}_pilot_freq"),
            )
        )
    if method == "custom":
        runs = [tuple(r) for r in getattr(node, f"{side}_subcarrier_alloc")]
        return tuple(sc_mod.custom_alloc(m, runs))
    return None  # liquid-style default


def build_node(
    i: int, nc: NodeConfig, mcfg: MediumConfig, log_sink, *, device: torch.device | str = "cuda"
):
    """Instantiate a scenario node from its typed config
    (the Initialize_CR path, src/crts_cognitive_radio.cpp:385-460), its
    device work on ``device`` (the card unless the caller asks for the CPU;
    with no card the default raises)."""
    if nc.node_type == "interferer":
        icfg = InterfererConfig(
            interference_type=nc.interference_type,
            period_s=nc.period,
            duty_cycle=nc.duty_cycle,
            tx_rate_hz=nc.tx_rate,
            tx_gain_soft_db=nc.tx_gain_soft,
            tx_freq_behavior=nc.tx_freq_behavior,
            tx_freq_hz=nc.tx_freq,
            tx_freq_min_hz=nc.tx_freq_min,
            tx_freq_max_hz=nc.tx_freq_max,
            tx_freq_dwell_s=nc.tx_freq_dwell_time,
            tx_freq_resolution_hz=nc.tx_freq_resolution,
        )
        return InterfererNode(
            i, mcfg.sample_rate_hz, mcfg.center_hz, icfg, log_sink, seed=i, device=device
        )
    if nc.cognitive_radio_type == "python-process":
        # the reference runs a third-party radio as its own OS process
        # (runtime/procradio.py, the fork + execvp of
        # src/crts_cognitive_radio.cpp:660-720); not ported yet
        raise NotImplementedError(
            "cognitive_radio_type 'python-process' needs runtime/procradio.py, "
            "not ported yet (ROADMAP Queue 1: procradio.py); use 'python' to "
            "load the radio in this process"
        )
    if nc.cognitive_radio_type == "python":
        # third-party radio support, in-process variant: the same
        # create_node(node_id, medium_rate, medium_center, config)
        # contract loaded into this interpreter (lighter, no isolation)
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            f"crn_user_radio_{i}", nc.python_file
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.create_node(i, mcfg.sample_rate_hz, mcfg.center_hz, nc)
    bridge = None
    if nc.net_traffic_type == "udp":
        # real-application data plane: ingress datagrams ride the link
        from cognitive_radio_network_tpu_torch.runtime.traffic import UdpBridge

        bridge = UdpBridge(
            nc.udp_listen_port, nc.udp_forward_addr, nc.udp_forward_port
        )
    node = RadioNode(
        i,
        mcfg.sample_rate_hz,
        mcfg.center_hz,
        engine_name=nc.cognitive_engine,
        ce_args=nc.ce_args.split() if nc.ce_args else [],
        ce_timeout_ms=nc.ce_timeout_ms,
        traffic=TrafficConfig(
            traffic_type="stream" if bridge is not None else nc.net_traffic_type,
            mean_throughput_bps=nc.net_mean_throughput,
            burst_length=nc.net_burst_length,
        ),
        log_sink=log_sink,
        rx_overflow_interval=nc.rx_overflow_interval,
        udp_bridge=bridge,
        device=device,
    )
    r = node.radio
    r.print_rx_frame_metrics = nc.print_rx_frame_metrics
    r.underrun_detect = nc.tx_underrun_detect
    r.rx_scan_accumulate = max(int(nc.rx_scan_blocks), 1)
    # receiver-referred thermal noise (runtime/medium.py): deterministic
    # per (scenario seed, node index) in BOTH the in-process and the
    # distributed runtime, so the two modes stay block-for-block identical
    r.rx_noise_power = mcfg.noise_power
    r.noise_seed = (int(mcfg.seed), int(i))
    r.set_tx_freq(nc.tx_freq)
    r.set_tx_rate(nc.tx_rate)
    r.set_tx_gain(nc.tx_gain - 20.0)  # UHD dB ref: 20 dB ~ unit gain
    r.set_tx_gain_soft(nc.tx_gain_soft)
    r.set_tx_modulation(nc.tx_modulation)
    r.set_tx_crc(nc.tx_crc)
    r.set_tx_fec0(nc.tx_fec0)
    r.set_tx_fec1(nc.tx_fec1)
    r.set_tx_subcarriers(nc.tx_subcarriers)
    r.set_tx_cp_len(nc.tx_cp_len)
    r.set_tx_taper_len(nc.tx_taper_len)
    r.set_tx_subcarrier_alloc(_alloc_for(nc, "tx"))
    r.set_rx_freq(nc.rx_freq)
    r.set_rx_rate(nc.rx_rate)
    r.set_rx_gain(nc.rx_gain - 20.0)
    r.set_rx_subcarriers(nc.rx_subcarriers)
    r.set_rx_cp_len(nc.rx_cp_len)
    r.set_rx_taper_len(nc.rx_taper_len)
    r.set_rx_subcarrier_alloc(_alloc_for(nc, "rx"))
    return node


def _replace_cfg(node: InterfererNode, **kw) -> None:
    node.cfg = dataclasses.replace(node.cfg, **kw)


def apply_node_control(
    node,
    param: CrtsParam,
    value,
    on_fb_en: Callable[[int], None] | None = None,
) -> None:
    """Apply one control parameter to a node object.

    ``on_fb_en`` handles CrtsParam.FB_EN (the runtime decides where the
    feedback-enable mask lives: the SC in-process, the node client over TCP).
    """
    if isinstance(node, InterfererNode):
        mapping = {
            CrtsParam.TX_STATE: lambda v: setattr(node, "tx_state", int(v)),
            CrtsParam.TX_FREQ: lambda v: node.set_tx_freq(v),
            CrtsParam.TX_DUTY_CYCLE: lambda v: _replace_cfg(node, duty_cycle=float(v)),
            CrtsParam.TX_PERIOD: lambda v: _replace_cfg(node, period_s=float(v)),
            CrtsParam.TX_FREQ_BEHAVIOR: lambda v: _replace_cfg(
                node, tx_freq_behavior=str(v)
            ),
            CrtsParam.TX_FREQ_MIN: lambda v: _replace_cfg(node, tx_freq_min_hz=float(v)),
            CrtsParam.TX_FREQ_MAX: lambda v: _replace_cfg(node, tx_freq_max_hz=float(v)),
            CrtsParam.TX_FREQ_DWELL_TIME: lambda v: _replace_cfg(
                node, tx_freq_dwell_s=float(v)
            ),
            CrtsParam.TX_FREQ_RES: lambda v: _replace_cfg(
                node, tx_freq_resolution_hz=float(v)
            ),
        }
    else:
        r = node.radio
        mapping = {
            CrtsParam.TX_STATE: lambda v: r.start_tx() if v else r.stop_tx(),
            CrtsParam.TX_FREQ: r.set_tx_freq,
            CrtsParam.TX_RATE: r.set_tx_rate,
            CrtsParam.TX_GAIN: r.set_tx_gain,
            CrtsParam.TX_MOD: r.set_tx_modulation,
            CrtsParam.TX_CRC: r.set_tx_crc,
            CrtsParam.TX_FEC0: r.set_tx_fec0,
            CrtsParam.TX_FEC1: r.set_tx_fec1,
            CrtsParam.RX_STATE: lambda v: r.start_rx() if v else r.stop_rx(),
            CrtsParam.RX_FREQ: r.set_rx_freq,
            CrtsParam.RX_RATE: r.set_rx_rate,
            CrtsParam.RX_GAIN: r.set_rx_gain,
            CrtsParam.RX_STATS_RESET: lambda v: r.reset_rx_stats(),
            CrtsParam.RX_STATS_FB: lambda v: setattr(
                r, "rx_stat_fb_period_s", float(v)
            ),
            # PACKET_LEN * 8 bits per packet / target bps
            CrtsParam.NET_THROUGHPUT: lambda v: setattr(
                node.traffic, "mean_interval", 2048.0 / float(v)
            ),
            CrtsParam.FB_EN: lambda v: (
                on_fb_en(int(v)) if on_fb_en is not None else None
            ),
        }
    fn = mapping.get(param)
    if fn is None:
        raise KeyError(f"unsupported control param {param}")
    fn(value)


# Feedback sources for delta detection (src/crts_cognitive_radio.cpp:208-383).
FB_GETTERS = {
    CrtsParam.TX_STATE: lambda r: r.get_tx_state(),
    CrtsParam.TX_FREQ: lambda r: r.get_tx_freq(),
    CrtsParam.TX_RATE: lambda r: r.get_tx_rate(),
    CrtsParam.TX_GAIN: lambda r: r.get_tx_gain(),
    CrtsParam.TX_MOD: lambda r: r.get_tx_modulation(),
    CrtsParam.TX_CRC: lambda r: r.get_tx_crc(),
    CrtsParam.TX_FEC0: lambda r: r.get_tx_fec0(),
    CrtsParam.TX_FEC1: lambda r: r.get_tx_fec1(),
    CrtsParam.RX_STATE: lambda r: int(r.rx_running),
    CrtsParam.RX_FREQ: lambda r: r.get_rx_freq(),
    CrtsParam.RX_RATE: lambda r: r.get_rx_rate(),
    CrtsParam.RX_GAIN: lambda r: r.get_rx_gain(),
}
