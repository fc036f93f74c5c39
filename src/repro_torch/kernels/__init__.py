"""Hand-written CUDA kernels of the port, one for each Pallas kernel of
the JAX package, each with a plain PyTorch version beside it:

  halfgate/ref.py          — the ARX Davies–Meyer hash and Half-Gate garble /
                             eval in int32 torch (shared by every GC kernel)
  csrc/halfgate.cuh        — the same cipher in CUDA, shared by the kernels
  level_eval/              — garble / eval of one padded netlist level
  halfgate/halfgate.py     — garble / eval of independent AND gates
  label_select/            — active-label encoding W0 ^ (bit ? R : 0)
  ntt/                     — negacyclic NTT and inverse for primes < 2^31

Each package keeps its CUDA source under ``csrc/``. A wrapper given a CPU
tensor runs the plain version; given a CUDA tensor it launches the kernel
(built with ``nvcc`` on first use, see :mod:`repro_torch.kernels.build`)
or raises.
"""
