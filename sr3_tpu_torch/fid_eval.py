"""FID / IS of generated images, the port's counterpart of
``tools/fid_eval.py`` (the same CLI and the same summary lines), on the
port's own FID code and image reader.

  # proxy-FID (seeded random-feature extractor on the card) over a
  # results directory: *_sr.png generated vs *_hr.png real
  python -m sr3_tpu_torch.fid_eval -p experiments/<run>/results

  # two arbitrary directories
  python -m sr3_tpu_torch.fid_eval --real <hr dir> --fake <sr dir>

  # canonical FID from precomputed InceptionV3 features: an npz with
  # arrays 'real' and 'fake' (N, D), or 'fake' + real stats 'mu' / 'sigma',
  # and optionally the fake set's classifier 'logits' for IS
  python -m sr3_tpu_torch.fid_eval --features-npz feats.npz

The extractor runs on the card; ``SR3_PLATFORM=cpu`` runs it on the CPU.
Proxy-FID scores are comparable only across runs with the same --seed and
--width (in either package); they are not on the published Inception-FID
scale.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

import sr3_tpu_torch.utils.metrics as Metrics
from sr3_tpu_torch.utils import fid as F


def _load_dir(paths):
    return np.stack([Metrics.load_img(p) for p in paths])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-p", "--path", type=str, default=None,
                    help="results dir with *_hr.png / *_sr.png pairs")
    ap.add_argument("--real", type=str, default=None)
    ap.add_argument("--fake", type=str, default=None)
    ap.add_argument("--features-npz", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--extractor", choices=["proxy", "inception"],
                    default="proxy",
                    help="'inception': torchvision InceptionV3 (2048-d "
                         "pooled features, published-scale FID + real IS); "
                         "weights via --weights or SR3_INCEPTION_WEIGHTS")
    ap.add_argument("--weights", type=str, default=None,
                    help="local torchvision inception_v3 state_dict path")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--is-splits", type=int, default=10)
    args = ap.parse_args(argv)

    if args.features_npz:
        z = np.load(args.features_npz)
        fake = z["fake"]
        if "real" in z:
            stats_r = F.activation_statistics(z["real"])
        else:
            stats_r = (z["mu"], z["sigma"])
        score = F.frechet_distance(*stats_r, *F.activation_statistics(fake))
        print(f"# FID (provided features): {score:.4f}")
        if "logits" in z:
            m, s = F.inception_score(z["logits"], splits=args.is_splits)
            print(f"# IS: {m:.4f} +/- {s:.4f}")
        return

    if args.path:
        real_paths = sorted(glob.glob(f"{args.path}/*_hr.png"))
        fake_paths = sorted(glob.glob(f"{args.path}/*_sr.png"))
    elif args.real and args.fake:
        real_paths = sorted(glob.glob(os.path.join(args.real, "*.png"))
                            + glob.glob(os.path.join(args.real, "*.jpg")))
        fake_paths = sorted(glob.glob(os.path.join(args.fake, "*.png"))
                            + glob.glob(os.path.join(args.fake, "*.jpg")))
    else:
        ap.error("need -p, or --real + --fake, or --features-npz")
    if len(real_paths) < 2 or len(fake_paths) < 2:
        raise SystemExit(f"need >=2 images per side, got {len(real_paths)} "
                         f"real / {len(fake_paths)} fake")

    if args.extractor == "inception":
        extractor = F.InceptionV3FeatureExtractor(weights=args.weights)
        feats_r = extractor(_load_dir(real_paths), args.batch)
        feats_f, logits_f = extractor.features_and_logits(
            _load_dir(fake_paths), args.batch)
        score = F.fid_from_features(feats_r, feats_f)
        tag = ("inception-FID" if extractor.canonical
               else "inception-FID (RANDOM INIT — run-local scale only)")
        print(f"# {tag} ({len(real_paths)} real / "
              f"{len(fake_paths)} fake): {score:.4f}")
        m, sd = F.inception_score(logits_f, splits=args.is_splits)
        print(f"# IS: {m:.4f} +/- {sd:.4f}")
        return

    extractor = F.RandomFeatureExtractor(seed=args.seed, width=args.width)
    feats_r = extractor(_load_dir(real_paths), args.batch)
    feats_f = extractor(_load_dir(fake_paths), args.batch)
    score = F.fid_from_features(feats_r, feats_f)
    print(f"# proxy-FID (seed {args.seed}, width {args.width}, "
          f"{len(real_paths)} real / {len(fake_paths)} fake): {score:.4f}")
    # no proxy-IS: random features carry no class semantics; give logits
    # through --features-npz instead


if __name__ == "__main__":
    main()
