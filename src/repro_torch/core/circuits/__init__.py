from repro_torch.core.circuits.builder import CircuitBuilder, Word

__all__ = ["CircuitBuilder", "Word"]
