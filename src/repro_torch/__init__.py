"""APINT on PyTorch and CUDA: the privacy plane ported from ``repro``.

A second package beside the JAX one, laid out the same way so each
module's counterpart sits at the same path:

  * ``core``    — netlists, circuits, secret sharing, the garbled-circuit
    executor, the PiT protocol and the compile → preprocess → run session;
  * ``kernels`` — hand-written CUDA kernels for the H100, each with a plain
    PyTorch version beside it (the CPU path and the kernel's oracle);
  * ``serve``   — the in-process private serving engine;
  * ``obs``     — host-side tracing.

Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions instead. Shares stay
numpy ``uint64`` on the host; garbled-circuit labels and tables are
``int32`` tensors holding the bit pattern of 32-bit unsigned words.
"""

__version__ = "0.1.0"
