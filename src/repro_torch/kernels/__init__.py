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


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name (the NTT's
    forward and inverse together, as ``ntt``)."""
    from repro_torch.kernels.halfgate import halfgate as HG
    from repro_torch.kernels.label_select import label_select as LS
    from repro_torch.kernels.level_eval import level_eval as LE
    from repro_torch.kernels.ntt import ntt as NTT

    return {"garble_walk": LE.garble_walk.launches,
            "eval_walk": LE.eval_walk.launches,
            "garble_level": LE.garble_level.launches,
            "eval_level": LE.eval_level.launches,
            "select_labels": LS.select_labels.launches,
            "ntt": NTT.ntt_forward.launches + NTT.ntt_inverse.launches,
            "garble_gates": HG.garble_gates.launches,
            "eval_gates": HG.eval_gates.launches}
