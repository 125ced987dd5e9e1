"""Moment transforms on the polar-to-Cartesian conversion.

The reference's transform studies outside the filtering loop:
``research/gpq/polar2cartesian.py`` (GPQ vs classical transforms by the
symmetrized KL divergence to Monte-Carlo truth), ``research/bsq/bsq_mtran.py``
(BSQ included) and ``research/truncated_mt_demo.py`` (truncated UT vs UT as
the state grows by dimensions the function does not read).  The BSQ-UT
weights go through the Vandermonde kernel on the card.

Usage: python -m ssmtoybox_torch.experiments.polar2cartesian_mt [--mc 100000]
           [--seed 0] [--device cuda|cpu]
"""
import math
from types import SimpleNamespace

import numpy as np
import torch

from ..bq.transforms import BayesSardTransform, GaussianProcessTransform
from ..mtran import (GaussHermiteTransform, LinearizationTransform, MonteCarloTransform,
                     SphericalRadialTransform, TruncatedUnscentedTransform, UnscentedTransform)
from ..utils import symmetrized_kl_divergence
from .common import device_of, generators, parser, print_tables

DIMS = (2, 3, 5, 8)


def polar2cartesian(x, time):
    """``r [cos(theta), sin(theta)]`` of each row ``x = (r, theta, ...)``."""
    return x[..., :1] * torch.stack([torch.cos(x[..., 1]), torch.sin(x[..., 1])], dim=-1)


def parse(argv=None):
    ap = parser(__doc__, 0, latex=False)
    ap.add_argument("--mc", type=int, default=100_000)
    return ap.parse_args(argv)


def _moments(dim, dev):
    """The input mean and covariance, padded to ``dim`` with unit variances."""
    mean = torch.tensor([1.0, math.pi / 6] + [0.0] * (dim - 2), dtype=torch.float64, device=dev)
    cov = torch.diag(torch.tensor([0.05 ** 2, (math.pi / 10) ** 2] + [1.0] * (dim - 2),
                                  dtype=torch.float64, device=dev))
    return mean, cov


def build(args):
    """The seven transforms of the first table and, for each dimension of
    the second, the UT and the truncated UT with their input moments."""
    dev = device_of(args.device)
    kpar = np.array([[1.0, 0.5, 0.5]])
    mulind = np.hstack([np.zeros((2, 1), dtype=int), np.eye(2, dtype=int),
                        2 * np.eye(2, dtype=int)])
    transforms = {
        "Linearization": LinearizationTransform(2, device=dev),
        "MC-1000": MonteCarloTransform.create(2, n=1000, seed=1, device=dev),
        "SR": SphericalRadialTransform(2, device=dev),
        "UT": UnscentedTransform(2, device=dev),
        "GH-5": GaussHermiteTransform(2, degree=5, device=dev),
        "GPQ-UT": GaussianProcessTransform(2, 2, kpar, point_str="ut", device=dev),
        "BSQ-UT": BayesSardTransform(2, 2, kpar, multi_ind=mulind, point_str="ut", device=dev),
    }
    truncated = {dim: (UnscentedTransform(dim, device=dev),
                       TruncatedUnscentedTransform(dim, 2, device=dev)) for dim in DIMS}
    moments = {d: _moments(d, dev) for d in DIMS}
    mean, cov = moments[2]
    return SimpleNamespace(device=dev, mean=mean, cov=cov, transforms=transforms,
                           truncated=truncated, moments=moments)


def main(argv=None):
    args = parse(argv)
    b = build(args)
    (gen,) = generators(b.device, args.seed)
    # Monte-Carlo ground truth moments
    z = torch.randn(args.mc, 2, generator=gen, dtype=torch.float64, device=b.device)
    xs = b.mean + z @ torch.linalg.cholesky(b.cov).T
    fs = polar2cartesian(xs, None)
    mean_mc, cov_mc = fs.mean(0), torch.cov(fs.T)
    tables = {}

    rows = {}
    for name, tf in b.transforms.items():
        mf, cf, _ = tf.apply(polar2cartesian, b.mean, b.cov, None)
        rows[name] = {"mean_err": float(torch.linalg.vector_norm(mf - mean_mc)),
                      "skl": float(symmetrized_kl_divergence(mean_mc, cov_mc, mf, cf))}
    title = "polar2cartesian moment transforms (vs MC truth)"
    tables[title] = rows
    print_tables(rows, title)

    # truncated UT with growing irrelevant state dimension (truncated_mt_demo.py)
    rows = {}
    for dim, (ut, tut) in b.truncated.items():
        mean_d, cov_d = b.moments[dim]
        mf_full, cf_full, _ = ut.apply(polar2cartesian, mean_d, cov_d, None)
        mf_tr, cf_tr, _ = tut.apply(polar2cartesian, mean_d, cov_d, None)
        rows[f"dim={dim}"] = {
            "UT_skl": float(symmetrized_kl_divergence(mean_mc, cov_mc, mf_full, cf_full)),
            "TUT_skl": float(symmetrized_kl_divergence(mean_mc, cov_mc, mf_tr, cf_tr)),
        }
    title = "truncated UT vs UT, growing irrelevant dims"
    tables[title] = rows
    print_tables(rows, title)
    return tables


if __name__ == "__main__":
    main()
