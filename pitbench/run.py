"""Run one cell of the benchmark once on the card.

    python3 pitbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Kernels build into ``build/kernels/`` of
the checkout on the first run and are reused after; every other cache a
library might write goes under ``build/pitbench/`` there.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    cache = ROOT / "build" / "pitbench"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    # the slabs' tables are freed and allocated again in other sizes
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from pitbench import harness

    return harness.main(sys.argv[1:], t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
