#!/usr/bin/env python3
"""Metric parity of cdae_tpu_torch's MF family (MF, PMF, PMF_DENSE, BPR,
BPR_DENSE, WARP, WARP_DENSE) against the C++ oracle: those cells of
scripts/torch_parity_zoo.py's table, whose docstring gives the protocol,
the gates and the options.

    python3 scripts/torch_parity_mf.py --device cuda
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity_zoo import MF_CELLS, main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(MF_CELLS))
