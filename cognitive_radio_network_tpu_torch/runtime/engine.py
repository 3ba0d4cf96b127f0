"""Cognitive-engine protocol: events, metrics, plug-in registry.

Port of the reference's CE event model (include/extensible_cognitive_radio.hpp:65-91
enum CE_Event and the metric_s struct :161-236) and the plug-in contract
``class CognitiveEngine { virtual void execute(); ECR* }``
(include/cognitive_engine.hpp:21-45).  The reference registers engines by
scanning directories and code-generating an if-chain
(src/config_cognitive_engines.cpp); here a decorator registry replaces the
code-gen (SURVEY.md §2.7 item 12).

Port of ``cognitive_radio_network_tpu/runtime/engine.py``, copied.  Its
registries are the port's own, apart from the reference's: importing the
port's ``engines`` and ``controllers`` packages fills them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional

import numpy as np

__all__ = [
    "CEEvent",
    "CEMetrics",
    "CognitiveEngine",
    "register_engine",
    "create_engine",
    "engine_names",
    "register_controller",
    "create_controller",
    "controller_names",
]


class CEEvent(enum.Enum):
    """include/extensible_cognitive_radio.hpp:65-91."""

    TIMEOUT = 0
    PHY_FRAME_RECEIVED = 1
    TX_COMPLETE = 2
    UHD_OVERFLOW = 3
    UHD_UNDERRUN = 4
    USRP_RX_SAMPS = 5


class FrameType(enum.IntEnum):
    """Frame types packed into header[0] bits 6-7
    (include/extensible_cognitive_radio.hpp frame type enum)."""

    DATA = 0
    CONTROL = 1
    UNKNOWN = 2


@dataclasses.dataclass
class CEMetrics:
    """The CE_metrics struct (include/extensible_cognitive_radio.hpp:161-236):
    everything an engine may inspect when executed."""

    ce_event: CEEvent = CEEvent.TIMEOUT
    frame_type: int = FrameType.UNKNOWN
    frame_num: int = 0
    control_info: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(6, np.uint8)
    )
    header: Optional[np.ndarray] = None
    header_valid: bool = False
    payload: Optional[np.ndarray] = None
    payload_valid: bool = False
    stats: Any = None  # phy.FrameSyncStats for PHY_FRAME_RECEIVED
    time_s: float = 0.0  # simulation timestamp of the event


class CognitiveEngine:
    """Base engine. Subclasses override execute(); the radio runtime calls it
    on every event (serialized, like ECR_ce_worker's CE_mutex loop,
    src/extensible_cognitive_radio.cpp:1761-1808)."""

    def __init__(self, radio, args: list[str] | None = None):
        self.radio = radio  # the ECR pointer equivalent
        self.args = args or []

    def execute(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


_ENGINES: dict[str, type] = {}
_CONTROLLERS: dict[str, type] = {}


def register_engine(name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        _ENGINES[name] = cls
        return cls

    return deco


def create_engine(name: str, radio, args: list[str] | None = None) -> CognitiveEngine:
    # built-in engines live in cognitive_radio_network_tpu_torch.engines; importing
    # the package populates the registry (replaces set_ce's if-chain,
    # src/extensible_cognitive_radio.cpp:354-369)
    import cognitive_radio_network_tpu_torch.engines  # noqa: F401

    if name not in _ENGINES:
        raise KeyError(f"unknown cognitive engine {name!r}; have {sorted(_ENGINES)}")
    return _ENGINES[name](radio, args)


def engine_names() -> list[str]:
    import cognitive_radio_network_tpu_torch.engines  # noqa: F401

    return sorted(_ENGINES)


def register_controller(name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        _CONTROLLERS[name] = cls
        return cls

    return deco


def create_controller(name: str, args: list[str] | None = None):
    import cognitive_radio_network_tpu_torch.controllers  # noqa: F401

    if name not in _CONTROLLERS:
        raise KeyError(
            f"unknown scenario controller {name!r}; have {sorted(_CONTROLLERS)}"
        )
    return _CONTROLLERS[name](args)


def controller_names() -> list[str]:
    import cognitive_radio_network_tpu_torch.controllers  # noqa: F401

    return sorted(_CONTROLLERS)
