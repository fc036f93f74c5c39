#!/usr/bin/env python
"""Lint entry point of the PyTorch port — see ``repro_torch.analysis.cli``
for the flags. The counterpart of ``scripts/lint.py``; it reads source
files and netlists only, so it runs on the host and takes no device.

Usage (from the repo root):

    python scripts/lint_torch.py --all \\
        --baseline src/repro_torch/analysis/baseline.json
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
