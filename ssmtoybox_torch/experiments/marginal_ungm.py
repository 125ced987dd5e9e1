"""UNGM study of the GPQ Kalman filter with marginalized kernel parameters.

The reference ships ``MarginalizedGaussianProcessKalman`` (``ssinf.py:1276-1292``)
but no study of it.  Here its damped-Newton form runs every Monte-Carlo
trajectory at once, each with its own parameter posterior: RMSE / NCI / INC
/ NLL against the UKF and the GPQKF with the fixed default kernel
parameters (ones) that the marginalized filter starts from.

Usage: python -m ssmtoybox_torch.experiments.marginal_ungm [--steps 100] [--mc 100]
           [--seed 42] [--newton-iters 15] [--damping 1e-2] [--inner f64|f32]
           [--latex] [--device cuda|cpu]

``--inner f32`` runs the Laplace parameter search in float32, the state
moments in float64: a method variant whose study scores land within the
method's spread (the per-step parameter posterior is multimodal, and mode
selection depends on precision), not a bit-compatible substitute.
"""
from types import SimpleNamespace

import numpy as np

from .. import ssinf
from ..ssmod import UNGMMeasurement, UNGMTransition
from ..utils import GaussRV
from .common import device_of, generators, parser, print_tables, run_filter_bank


def parse(argv=None):
    ap = parser(__doc__, 42)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mc", type=int, default=100)
    ap.add_argument("--newton-iters", type=int, default=15)
    # 1e-2 (the library's default is 1e-3) loses fewer runs on this study
    ap.add_argument("--damping", type=float, default=1e-2)
    ap.add_argument("--inner", choices=["f64", "f32"], default="f64",
                    help="precision of the Laplace Newton inner loop")
    return ap.parse_args(argv)


def build(args):
    """The UNGM models, the UKF, the fixed-parameter GPQKF and the
    marginalized GPQKF with the search's settings."""
    dev = device_of(args.device)
    dyn = UNGMTransition(GaussRV(1, cov=5.0, device=dev), GaussRV(1, cov=10.0, device=dev))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=1)
    kp = np.ones((1, 2))
    mgpq = ssinf.MarginalizedGaussianProcessKalman(dyn, obs, points="ut")
    mgpq.newton_iters = args.newton_iters
    mgpq.damping = args.damping
    if args.inner == "f32":
        mgpq.inner_dtype = "float32"
    algs = {
        "UKF": ssinf.UnscentedKalman(dyn, obs),
        "GPQKF-fix": ssinf.GaussianProcessKalman(dyn, obs, kp, kp, points="ut"),
        "MGPQKF": mgpq,
    }
    return SimpleNamespace(device=dev, dyn=dyn, obs=obs, algs=algs)


def main(argv=None):
    args = parse(argv)
    b = build(args)
    gen_x, gen_y = generators(b.device, args.seed, args.seed + 1)
    x = b.dyn.simulate_discrete(gen_x, steps=args.steps, mc_sims=args.mc)
    y = b.obs.simulate_measurements(gen_y, x)
    rows, _ = run_filter_bank(b.algs, y, x)
    title = f"UNGM marginalized study, steps={args.steps}, mc={args.mc}"
    print_tables(rows, title, args.latex, ["rmse", "rmse_2std", "nci", "inc", "nll", "nll_2std",
                                           "diverged", "wallclock_s"])
    return {title: rows}


if __name__ == "__main__":
    main()
