from repro_torch.utils.log import get_logger

__all__ = ["get_logger"]
