#!/usr/bin/env python
"""xMUDA / xMUDA+PL training CLI (port of ``mopa_tpu/train/train_xmuda.py``; reference
``mopa/train/train_xmuda.py``).

``python -m mopa_tpu_torch.train.train_xmuda --cfg <yaml> [KEY VALUE ...]``
on a CUDA device.
"""

from mopa_tpu_torch.train.common import main_common


def main():
    main_common("xmuda", "xMUDA training (GPU)",
                "configs/nuscenes/usa_singapore/xmuda.yaml")


if __name__ == "__main__":
    main()
