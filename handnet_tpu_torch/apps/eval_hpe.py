"""Standalone HPE evaluation CLI: result file -> MPJPE/AUC table.

The port's ``handnet_tpu/apps/eval_hpe.py``: host code alone, with no
device. Reference flow: dex-ycb-toolkit examples/evaluate_hpe.py +
HPEEvaluator (hpe_eval.py:174-269). Consumes the same 64-field result files; GT comes
from a DexYCB directory (or the synthetic tree) or a cached npz.

Usage:
  python -m handnet_tpu_torch.apps.eval_hpe --res-file s0_test_45.txt
      --data-dir $DEX_YCB_DIR --split s0_test
  python -m handnet_tpu_torch.apps.eval_hpe --res-file r.txt --gt-npz gt.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from handnet_tpu_torch.eval.hpe import HPEEvaluator


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--res-file", required=True)
    parser.add_argument("--data-dir", default=os.environ.get("DEX_YCB_DIR"))
    parser.add_argument("--split", default="s0_test")
    parser.add_argument("--gt-npz", default=None,
                        help="npz of {image_id: joints[21,3] mm} instead of "
                             "reading the dataset")
    parser.add_argument("--out-dir", default=None)
    parser.add_argument("--epoch", default="0")
    args = parser.parse_args(argv)

    if args.gt_npz:
        data = np.load(args.gt_npz)
        gt = {int(k): data[k] for k in data.files}
    else:
        from handnet_tpu_torch.data.dexycb import get_dataset, hpe_ground_truth

        ds = get_dataset(args.split, data_dir=args.data_dir)
        gt = hpe_ground_truth(ds)

    evaluator = HPEEvaluator(gt)
    results = evaluator.evaluate(args.epoch, args.res_file)
    print(evaluator.report(results))
    if args.out_dir:
        evaluator.save_epoch_metrics(args.out_dir)
        print(f"metrics saved to {args.out_dir}")
    return results


if __name__ == "__main__":
    main()
