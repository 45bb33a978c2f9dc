"""Evaluation (port of the JAX package's ``evaluation/``): FID, sFID,
Inception Score and precision/recall over Inception features, CLIP score,
the npz packers, the Inception extractor and the ``run_eval`` CLI.  The
metric math is numpy/scipy, a copy of the JAX package's; the extractor and
the CLIP towers run on the port's device."""

from .clip_score import clip_score_from_features
from .fid import (compute_fid, compute_inception_score,
                  compute_precision_recall, compute_statistics,
                  frechet_distance, full_report)
from .npz_io import images_to_npz, latents_to_images, load_npz_images

__all__ = ["clip_score_from_features", "compute_fid",
           "compute_inception_score", "compute_precision_recall",
           "compute_statistics", "frechet_distance", "full_report",
           "images_to_npz", "latents_to_images", "load_npz_images"]
