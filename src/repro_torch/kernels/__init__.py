"""Hand-written CUDA kernels for the privacy plane's hot loop.

Each kernel ships with a plain PyTorch version in the same package:

  halfgate/ref.py       — the ARX Davies–Meyer hash and Half-Gate garble /
                          eval in int32 torch (shared by every GC kernel)
  level_eval/ref.py     — plain garble / eval of one padded netlist level
  level_eval/level_eval.py + csrc/ — the CUDA kernels and their wrappers

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel (built with ``nvcc`` on first use, see
:mod:`repro_torch.kernels.build`) or raises.
"""
