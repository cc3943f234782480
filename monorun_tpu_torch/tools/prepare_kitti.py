"""Cache per-image (height, width) metadata (the counterpart of
``tools/prepare_kitti.py``).

    python -m monorun_tpu_torch.tools.prepare_kitti data/kitti/training train_list.txt
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from ..data.kitti import prepare_meta_files


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Cache per-image (h, w) metadata")
    p.add_argument("root")
    p.add_argument("list_file")
    p.add_argument("--out-prefix", default="img_metas")
    args = p.parse_args(argv)
    n = prepare_meta_files(args.root, args.list_file, args.out_prefix)
    print(f"wrote {n} meta files to {os.path.join(args.root, args.out_prefix)}")
    return n


if __name__ == "__main__":
    main()
