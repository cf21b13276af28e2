"""Loss-sensitivity study over the PyTorch port's criteria: the port's
counterpart of examples/loss_study.py, a thin front end of
`srgan_st_tpu_torch.tools.loss_study`.

Usage:
    python examples/loss_study_torch.py [--image path/to/96px/patch.png] [--out figures/]
        [--strengths 0 0.1 0.25 0.5 0.75 1] [--device cuda|cpu]

Runs on the GPU unless `--device cpu`; writes <out>/loss_study.png.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from srgan_st_tpu_torch.tools.loss_study import main  # noqa: E402

if __name__ == "__main__":
    main()
