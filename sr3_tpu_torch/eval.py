"""Offline PSNR / SSIM scoring of a results directory, the port's
counterpart of the root eval.py (the same CLI, pairing, summary lines and
JSON), on the port's own metric code.

  python -m sr3_tpu_torch.eval -p experiments/<run>/results
  python -m sr3_tpu_torch.eval -p <dir> --pattern '*_inf.png' --per-image --json out.json

``<stem>_sr.png`` pairs with ``<stem>_hr.png`` by stem; generated images
without a counterpart are reported and skipped. Images are read with cv2,
else Pillow, where they are opened.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import sr3_tpu_torch.utils.metrics as Metrics


def collect_pairs(path, sr_pattern="*_sr.png", hr_suffix="_hr.png"):
    """(pairs, unmatched): pairs is the sorted list of (stem, sr_path,
    hr_path), unmatched the generated paths without a ground truth."""
    sr_tag = "_" + sr_pattern.rsplit("_", 1)[-1].split(".")[0]  # e.g. '_sr'
    hr_by_stem = {os.path.basename(p)[: -len(hr_suffix)]: p
                  for p in glob.glob(os.path.join(path, "*" + hr_suffix))}
    pairs, unmatched = [], []
    for p in sorted(glob.glob(os.path.join(path, sr_pattern))):
        stem = os.path.basename(p).rsplit(sr_tag, 1)[0]
        hr = hr_by_stem.get(stem)
        if hr:
            pairs.append((stem, p, hr))
        else:
            unmatched.append(p)
    return pairs, unmatched


def score_pairs(pairs, per_image=False, log_every=20):
    """-> (records, avg_psnr, avg_ssim); records hold per-image metrics."""
    records = []
    for i, (stem, sr_path, hr_path) in enumerate(pairs, start=1):
        sr_img = Metrics.load_img(sr_path)
        hr_img = Metrics.load_img(hr_path)
        rec = {"name": stem,
               "psnr": float(Metrics.calculate_psnr(sr_img, hr_img)),
               "ssim": float(Metrics.calculate_ssim(sr_img, hr_img))}
        records.append(rec)
        if per_image or i % log_every == 0:
            print(f"Image:{i}, PSNR:{rec['psnr']:.4f}, "
                  f"SSIM:{rec['ssim']:.4f}  ({stem})")
    n = len(records)
    avg_psnr = sum(r["psnr"] for r in records) / n if n else float("nan")
    avg_ssim = sum(r["ssim"] for r in records) / n if n else float("nan")
    return records, avg_psnr, avg_ssim


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Score *_sr.png outputs against *_hr.png ground truth.")
    parser.add_argument("-p", "--path", type=str,
                        default="experiments/basic_sr_ffhq_210809_142238/"
                                "results",
                        help="results directory (train / infer output)")
    parser.add_argument("--pattern", type=str, default="*_sr.png",
                        help="glob for generated images; pairs with the "
                             "matching *_hr.png by stem")
    parser.add_argument("--per-image", action="store_true",
                        help="print every image's PSNR/SSIM, not every 20th")
    parser.add_argument("--json", type=str, default=None,
                        help="also write per-image + summary metrics here")
    args = parser.parse_args(argv)

    pairs, unmatched = collect_pairs(args.path, sr_pattern=args.pattern)
    if unmatched:
        more = "..." if len(unmatched) > 5 else ""
        print(f"warning: {len(unmatched)} generated image(s) have no _hr "
              f"counterpart and were skipped: {unmatched[:5]}{more}")
    if not pairs:
        print(f"no {args.pattern} / *_hr.png pairs under {args.path}",
              file=sys.stderr)
        return 1

    records, avg_psnr, avg_ssim = score_pairs(pairs, per_image=args.per_image)
    print(f"# Validation # PSNR: {avg_psnr:.4e}")
    print(f"# Validation # SSIM: {avg_ssim:.4e}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"path": args.path, "pattern": args.pattern,
                       "count": len(records), "avg_psnr": avg_psnr,
                       "avg_ssim": avg_ssim, "images": records}, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
