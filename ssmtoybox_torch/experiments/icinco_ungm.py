"""UNGM benchmark: classical sigma-point filters vs GPQ Kalman filters.

The study design of ``research/gpq/icinco_demo.py:81-229`` (RMSE / NCI /
NLL of UKF, CKF, GHKF against GPQKF with SR / UT / GH point sets), every
filter over all Monte-Carlo runs in one batched call.

Usage: python -m ssmtoybox_torch.experiments.icinco_ungm [--steps 500] [--mc 100]
           [--seed 42] [--engine f64|dd|auto] [--latex] [--device cuda|cpu]

``--engine dd`` runs every filter through the fused scalar filter kernel
(``csrc/scalar_filter.cu``; all seven rules have at most 8 points); a
filter that the kernel refuses runs in float64 with a stderr line, and the
table's ``engine`` column says which arithmetic each filter ran.
"""
from types import SimpleNamespace

import numpy as np

from .. import ssinf
from ..ssmod import UNGMMeasurement, UNGMTransition
from ..utils import GaussRV
from .common import device_of, generators, parser, print_tables, run_filter_bank


def parse(argv=None):
    ap = parser(__doc__, 42)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--mc", type=int, default=100)
    ap.add_argument("--engine", choices=["f64", "dd", "auto"], default="f64",
                    help="batch-filter arithmetic (see the module docstring)")
    return ap.parse_args(argv)


def build(args):
    """The UNGM models and the seven filters."""
    dev = device_of(args.device)
    dyn = UNGMTransition(GaussRV(1, cov=5.0, device=dev), GaussRV(1, cov=10.0, device=dev))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=1)
    # kernel parameters per point set (icinco_demo.py:91-93)
    d = dyn.dim_in
    kp_sr = np.array([[1.0, 0.3 * d]])
    kp_ut = np.array([[1.0, 3.0 * d]])
    kp_gh = np.array([[1.0, 0.1 * d]])
    algs = {
        "UKF": ssinf.UnscentedKalman(dyn, obs),
        "CKF": ssinf.CubatureKalman(dyn, obs),
        "GHKF-5": ssinf.GaussHermiteKalman(dyn, obs, deg=5),
        "GPQKF-SR": ssinf.GaussianProcessKalman(dyn, obs, kp_sr, kp_sr, points="sr"),
        "GPQKF-UT": ssinf.GaussianProcessKalman(dyn, obs, kp_ut, kp_ut, points="ut"),
        "GPQKF-GH5": ssinf.GaussianProcessKalman(dyn, obs, kp_gh, kp_gh, points="gh",
                                                 point_hyp={"degree": 5}),
        "GPQKF-GH7": ssinf.GaussianProcessKalman(dyn, obs, kp_gh, kp_gh, points="gh",
                                                 point_hyp={"degree": 7}),
    }
    return SimpleNamespace(device=dev, dyn=dyn, obs=obs, algs=algs)


def main(argv=None):
    args = parse(argv)
    b = build(args)
    gen_x, gen_y = generators(b.device, args.seed, args.seed + 1)
    x = b.dyn.simulate_discrete(gen_x, steps=args.steps, mc_sims=args.mc)
    y = b.obs.simulate_measurements(gen_y, x)
    rows, _ = run_filter_bank(b.algs, y, x, engine=args.engine)
    cols = ["rmse", "rmse_2std", "nci", "nci_2std", "nll", "nll_2std",
            "wallclock_s"] + (["engine"] if args.engine != "f64" else [])
    title = (f"UNGM, steps={args.steps}, mc={args.mc} (filtered, engine={args.engine})")
    print_tables(rows, title, args.latex, cols)
    return {title: rows}


if __name__ == "__main__":
    main()
