"""UNGM filter + smoother study: classical vs GPQ vs BSQ per point set.

``research/bsq/bsq_ungm.py:91-186``: UT / GH-5 / GH-7 rules, each with the
classical, the GPQ and the BSQ Kalman filter; filtered and smoothed RMSE /
NCI / NLL tables.  The BSQ weights go through the Vandermonde kernel
(``csrc/vandermonde.cu``) on the card.

Usage: python -m ssmtoybox_torch.experiments.bsq_ungm [--steps 500] [--mc 100]
           [--seed 0] [--latex] [--device cuda|cpu]
"""
from types import SimpleNamespace

import numpy as np

from .. import ssinf
from ..ssmod import UNGMMeasurement, UNGMTransition
from ..utils import GaussRV
from .common import (aggregate, device_of, generators, parser, print_tables, run_filter_bank,
                     study_scores)


def parse(argv=None):
    ap = parser(__doc__, 0)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--mc", type=int, default=100)
    return ap.parse_args(argv)


def build(args):
    """The UNGM models and the nine filters."""
    dev = device_of(args.device)
    dyn = UNGMTransition(GaussRV(1, cov=5.0, device=dev), GaussRV(1, cov=10.0, device=dev))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=1)
    par_ut = np.array([[3.0, 0.3]])
    par_gh5 = np.array([[5.0, 0.6]])
    par_gh7 = np.array([[3.0, 0.4]])
    mulind_ut = np.array([[0, 1, 2]])

    def mulind_gh(deg):
        return np.atleast_2d(np.arange(deg))

    def bsq(par, mulind, points, hyp=None):
        return ssinf.BayesSardKalman(dyn, obs, par, par, mulind_dyn=mulind, mulind_obs=mulind,
                                     points=points, point_hyp=hyp)

    algs = {
        "UT": ssinf.UnscentedKalman(dyn, obs, alpha=1.0, beta=0.0),
        "GH-5": ssinf.GaussHermiteKalman(dyn, obs, deg=5),
        "GH-7": ssinf.GaussHermiteKalman(dyn, obs, deg=7),
        "GPQ-UT": ssinf.GaussianProcessKalman(dyn, obs, par_ut, par_ut, points="ut"),
        "GPQ-GH5": ssinf.GaussianProcessKalman(dyn, obs, par_gh5, par_gh5, points="gh",
                                               point_hyp={"degree": 5}),
        "GPQ-GH7": ssinf.GaussianProcessKalman(dyn, obs, par_gh7, par_gh7, points="gh",
                                               point_hyp={"degree": 7}),
        "BSQ-UT": bsq(par_ut, mulind_ut, "ut"),
        "BSQ-GH5": bsq(par_gh5, mulind_gh(5), "gh", {"degree": 5}),
        "BSQ-GH7": bsq(par_gh7, mulind_gh(7), "gh", {"degree": 7}),
    }
    return SimpleNamespace(device=dev, dyn=dyn, obs=obs, algs=algs)


def main(argv=None):
    args = parse(argv)
    b = build(args)
    gen_x, gen_y = generators(b.device, args.seed, args.seed + 1)
    x = b.dyn.simulate_discrete(gen_x, steps=args.steps, mc_sims=args.mc)
    y = b.obs.simulate_measurements(gen_y, x)

    rows, raw = run_filter_bank(b.algs, y, x)
    tables = {}
    title = f"UNGM filtered, steps={args.steps}, mc={args.mc}"
    tables[title] = rows
    print_tables(rows, title, args.latex, ["rmse", "rmse_2std", "nci", "nci_2std", "nll",
                                           "nll_2std"])

    # smoothed scores: the RTS pass over each filter's batch result
    smoothed = {}
    for name, (res, _) in raw.items():
        sm, sP = ssinf.gaussian_smoother(res, rts_full=False)
        smoothed[name] = aggregate(study_scores(x, sm, sP), spread=False)
    title = "UNGM smoothed"
    tables[title] = smoothed
    print_tables(smoothed, title, args.latex, ["rmse", "nci", "nll", "diverged"])
    return tables


if __name__ == "__main__":
    main()
