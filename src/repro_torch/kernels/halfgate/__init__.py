"""Half-Gate garbling of independent AND gates: the port's public entry
points (the counterpart of the JAX package's ``kernels/halfgate/ops.py``)."""

from repro_torch.kernels.halfgate.halfgate import (
    eval_and_gates, garble_and_gates, hash_labels,
)

__all__ = ["eval_and_gates", "garble_and_gates", "hash_labels"]
