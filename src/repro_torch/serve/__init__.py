from repro_torch.serve.errors import BundlePoolEmpty
from repro_torch.serve.private_engine import (
    NetPrivateServeEngine,
    PrivateRequest,
    PrivateServeEngine,
)

__all__ = ["PrivateServeEngine", "NetPrivateServeEngine", "PrivateRequest",
           "BundlePoolEmpty"]
