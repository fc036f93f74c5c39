from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.errors import BundlePoolEmpty
from repro_torch.serve.private_engine import (
    NetPrivateServeEngine,
    PrivateRequest,
    PrivateServeEngine,
)

__all__ = [
    "ServeEngine",
    "PrivateServeEngine",
    "NetPrivateServeEngine",
    "PrivateRequest",
    "BundlePoolEmpty",
    "PitGateway",
    "gateway_client",
]

_GATEWAY_EXPORTS = ("PitGateway", "gateway_client")


def __getattr__(name):
    # the gateway sits on top of repro_torch.net.party, which itself
    # imports repro_torch.serve.errors — importing it eagerly here would
    # close that loop into a cycle, so it loads on first attribute access
    if name in _GATEWAY_EXPORTS:
        from repro_torch.serve import gateway
        return getattr(gateway, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
