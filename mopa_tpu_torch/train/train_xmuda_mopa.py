#!/usr/bin/env python
"""MoPA training CLI: xMUDA + pseudo-labels + VGI + SAM consistency + EMA
(port of ``mopa_tpu/train/train_xmuda_mopa.py``; reference
``mopa/train/train_xmuda_mopa.py``).

``python -m mopa_tpu_torch.train.train_xmuda_mopa --cfg <yaml> [KEY VALUE ...]``
on a CUDA device.
"""

from mopa_tpu_torch.train.common import main_common


def main():
    main_common("mopa", "MoPA training (GPU)",
                "configs/nuscenes/usa_singapore/xmuda_pl_mopa.yaml")


if __name__ == "__main__":
    main()
