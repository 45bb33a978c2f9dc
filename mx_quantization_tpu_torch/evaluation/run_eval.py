"""FID / IS / precision-recall evaluation CLI (port of the JAX package's
``evaluation/run_eval.py``; the reference's run_eval.sh -> evaluator.py as
one command):

    python -m mx_quantization_tpu_torch.evaluation.run_eval \\
        --ref imagenet256_ref.npz --gen samples.npz \\
        --inception pt_inception-2015-12-05-6726825d.pth

Inputs are uint8 image npzs ("arr_0"), whose Inception features are
extracted on the device (``--device``, the card by default), or feature
npzs with pool3/spatial/pred keys, used as they are.  Prints one JSON line
with fid / sfid / inception_score / precision / recall, the ADM
evaluator's metric set (evaluator.py:56-62).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .fid import full_report
from .npz_io import load_npz_images


def _load_features(path: str, inception_path, batch, device):
    z = np.load(path)
    if "pool3" in z:
        return {k: z[k] for k in z.files}
    if inception_path is None:
        raise SystemExit(
            "image npz given but no --inception weights; either supply the "
            "pt_inception checkpoint or precompute features")
    from .inception import (InceptionV3, extract_features_batched,
                            load_inception_checkpoint)
    model = InceptionV3(device)
    model.load_state_dict(load_inception_checkpoint(inception_path))
    return extract_features_batched(model, load_npz_images(path), batch)


def main(argv=None):
    p = argparse.ArgumentParser("MX eval: FID/sFID/IS/precision/recall")
    p.add_argument("--ref", required=True,
                   help="reference npz (images or features)")
    p.add_argument("--gen", required=True,
                   help="generated npz (images or features)")
    p.add_argument("--inception", default=None,
                   help="pt_inception torch checkpoint for feature extraction")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--save-features", default=None,
                   help="save generated-side features to this npz")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    ref = _load_features(args.ref, args.inception, args.batch, args.device)
    gen = _load_features(args.gen, args.inception, args.batch, args.device)
    if args.save_features:
        np.savez(args.save_features, **gen)

    report = full_report(ref["pool3"], gen["pool3"],
                         ref.get("spatial"), gen.get("spatial"),
                         gen.get("pred"))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
