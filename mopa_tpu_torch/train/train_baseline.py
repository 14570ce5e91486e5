#!/usr/bin/env python
"""Source-only baseline training CLI (port of ``mopa_tpu/train/train_baseline.py``; reference
``mopa/train/train_baseline.py``).

``python -m mopa_tpu_torch.train.train_baseline --cfg <yaml> [KEY VALUE ...]``
on a CUDA device.
"""

from mopa_tpu_torch.train.common import main_common


def main():
    main_common("baseline", "Baseline (source-only) training (GPU)",
                "configs/nuscenes/usa_singapore/baseline.yaml")


if __name__ == "__main__":
    main()
