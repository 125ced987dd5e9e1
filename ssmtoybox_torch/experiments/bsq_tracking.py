"""Reentry-vehicle radar tracking: BSQ Kalman filters with EMV overrides vs the UKF.

``research/bsq/bsq_tracking.py:223-340``: Euler-Maruyama ground truth
(``dt = 0.05``) with every second step kept, filters at ``dt = 0.1`` from a
mis-specified initial mean; BSQ Kalman filters with three fixed
expected-model-variance (EMV) settings against the UKF.  The overrides go
through ``tf.replace(model_var=...)``, the reference's mutation of
``alg.tf_dyn.model.model_var`` (``bsq_tracking.py:276-281``).  The BSQ
weights go through the Vandermonde kernel on the card; a matrix EMV has no
fused filter form, so every filter runs eagerly.

Usage: python -m ssmtoybox_torch.experiments.bsq_tracking [--dur 200] [--mc 10]
           [--seed 0] [--latex] [--device cuda|cpu]
"""
from types import SimpleNamespace

import numpy as np

from .. import ssinf
from ..ssmod import Radar2DMeasurement, ReentryVehicle2DTransition
from ..utils import GaussRV
from .common import device_of, generators, parser, print_tables, run_filter_bank

TAU, DISC_TAU = 0.05, 0.1


def parse(argv=None):
    ap = parser(__doc__, 0)
    ap.add_argument("--dur", type=float, default=200.0)
    ap.add_argument("--mc", type=int, default=10)
    return ap.parse_args(argv)


def build(args):
    """The truth system (``sys_dyn``, ``obs``), the mis-specified filter
    dynamics and the four filters, the EMV overrides applied."""
    dev = device_of(args.device)
    # reality (bsq_tracking.py:233-244)
    sys_dyn = ReentryVehicle2DTransition(
        GaussRV(5, mean=np.array([6500., 350., -1.8, -6.8, 0.7]),
                cov=np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1e-12]), device=dev),
        GaussRV(3, cov=np.diag([2.4e-5, 2.4e-5, 1e-12]), device=dev), dt=TAU)
    obs = Radar2DMeasurement(GaussRV(2, cov=np.diag([1e-6, 0.17e-6]), device=dev),
                             dim_state=5, radar_loc=np.array([6374.0, 0.0]))
    # filter model with a mis-specified initial mean (bsq_tracking.py:255-261)
    dyn = ReentryVehicle2DTransition(
        GaussRV(5, mean=np.array([6500., 350., -1.1, -6.1, 0.7]),
                cov=np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0]), device=dev),
        GaussRV(3, cov=np.diag([2.4e-5, 2.4e-5, 1e-6]), device=dev), dt=DISC_TAU)
    par_dyn = np.array([[1.0, 1, 1, 1, 1, 1]])
    par_obs = np.array([[1.0, 0.9, 0.9, 1e4, 1e4, 1e4]])
    mul_ut = np.hstack((np.zeros((5, 1), int), np.eye(5, dtype=int), 2 * np.eye(5, dtype=int)))

    def bsq():
        return ssinf.BayesSardKalman(dyn, obs, par_dyn, par_obs, mulind_dyn=mul_ut,
                                     mulind_obs=mul_ut, points="ut")

    algs = {"bsqkf": bsq(), "bsqkf_2e-6": bsq(), "bsqkf_2e-7": bsq(),
            "ukf": ssinf.UnscentedKalman(dyn, obs, beta=0.0)}
    # fixed EMV overrides (bsq_tracking.py:276-281)
    overrides = {
        "bsqkf": (np.diag([2e-4] * 5), np.zeros((2, 2))),
        "bsqkf_2e-6": (2e-6 * np.eye(5), np.zeros((2, 2))),
        "bsqkf_2e-7": (2e-7 * np.eye(5), np.zeros((2, 2))),
    }
    for name, (mv_dyn, mv_obs) in overrides.items():
        algs[name].tf_dyn = algs[name].tf_dyn.replace(model_var=mv_dyn)
        algs[name].tf_obs = algs[name].tf_obs.replace(model_var=mv_obs)
    return SimpleNamespace(device=dev, sys_dyn=sys_dyn, dyn=dyn, obs=obs, algs=algs)


def main(argv=None):
    args = parse(argv)
    b = build(args)
    gen_x, gen_y = generators(b.device, args.seed, args.seed + 1)
    x = b.sys_dyn.simulate_continuous(gen_x, duration=args.dur, dt=TAU, mc_sims=args.mc)
    y = b.obs.simulate_measurements(gen_y, x)
    x, y = x[:, ::2].contiguous(), y[:, ::2].contiguous()
    rows, _ = run_filter_bank(b.algs, y, x)
    title = f"Reentry tracking, dur={args.dur}s, mc={args.mc}"
    print_tables(rows, title, args.latex, ["rmse", "rmse_2std", "inc", "inc_2std", "wallclock_s"])
    return {title: rows}


if __name__ == "__main__":
    main()
