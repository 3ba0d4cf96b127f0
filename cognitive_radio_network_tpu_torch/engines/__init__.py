"""Built-in cognitive engines (ports of the reference's CE_* plug-ins).

Importing this package populates the engine registry — the decorator-based
replacement for the reference's code-generated registration if-chain
(src/config_cognitive_engines.cpp).
"""

from cognitive_radio_network_tpu_torch.engines import (  # noqa: F401
    template,
    markov_pu,
    random_pu,
    predictive_node,
    tx_channel_x,
)
