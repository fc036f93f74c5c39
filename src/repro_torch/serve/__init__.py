from repro_torch.serve.errors import BundlePoolEmpty
from repro_torch.serve.private_engine import PrivateRequest, PrivateServeEngine

__all__ = ["PrivateServeEngine", "PrivateRequest", "BundlePoolEmpty"]
