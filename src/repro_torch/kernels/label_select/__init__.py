"""Active-label encoding: the port's public entry point (the counterpart
of the JAX package's ``kernels/label_select/ops.py``)."""

from repro_torch.kernels.label_select.label_select import select_labels

__all__ = ["select_labels"]
