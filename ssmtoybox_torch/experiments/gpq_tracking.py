"""Reentry tracking with GPQ Kalman filters (``research/gpq/gpq_tracking.py``).

Euler-Maruyama ground truth at ``tau = 0.05``, every second step kept;
UKF vs GPQKF with UT points.

Usage: python -m ssmtoybox_torch.experiments.gpq_tracking [--dur 200] [--mc 20]
           [--seed 0] [--engine f64|dd|auto] [--device cuda|cpu]

Under ``--engine dd`` / ``auto`` the UKF runs in the shaped vector filter
kernel (``csrc/vector_filter_shaped.cu``) and the GPQKF in the kernel of the
BQ shapes (``csrc/vector_filter_shaped_bq.cu``).
"""
from types import SimpleNamespace

import numpy as np

from .. import ssinf
from ..ssmod import Radar2DMeasurement, ReentryVehicle2DTransition
from ..utils import GaussRV
from .common import device_of, generators, parser, print_tables, run_filter_bank

TAU = 0.05
M0 = [6500.4, 349.14, -1.8093, -6.7967, 0.6932]


def parse(argv=None):
    ap = parser(__doc__, 0, latex=False)
    ap.add_argument("--dur", type=float, default=200.0)
    ap.add_argument("--mc", type=int, default=20)
    ap.add_argument("--engine", choices=["f64", "dd", "auto"], default="f64")
    return ap.parse_args(argv)


def build(args):
    """The truth system (``sys_dyn``, ``obs``), the filters' dynamics at
    ``2 tau`` and the UKF and GPQKF."""
    dev = device_of(args.device)
    sys_dyn = ReentryVehicle2DTransition(
        GaussRV(5, mean=np.array(M0), cov=np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1e-12]), device=dev),
        GaussRV(3, cov=np.diag([2.4064e-5, 2.4064e-5, 1e-12]), device=dev), dt=TAU)
    obs = Radar2DMeasurement(GaussRV(2, cov=np.diag([1e-3, 0.17e-3]), device=dev),
                             dim_state=5, radar_loc=np.array([6374.0, 0.0]))
    dyn = ReentryVehicle2DTransition(
        GaussRV(5, mean=np.array(M0), cov=np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0]), device=dev),
        GaussRV(3, cov=np.diag([2.4064e-5, 2.4064e-5, 1e-6]), device=dev), dt=2 * TAU)
    kpar = np.array([[1.0, 25, 25, 25, 25, 25]])
    algs = {
        "UKF": ssinf.UnscentedKalman(dyn, obs, beta=0.0),
        "GPQKF": ssinf.GaussianProcessKalman(dyn, obs, kpar, kpar, points="ut"),
    }
    return SimpleNamespace(device=dev, sys_dyn=sys_dyn, dyn=dyn, obs=obs, algs=algs)


def main(argv=None):
    args = parse(argv)
    b = build(args)
    gen_x, gen_y = generators(b.device, args.seed, args.seed + 1)
    x = b.sys_dyn.simulate_continuous(gen_x, duration=args.dur, dt=TAU, mc_sims=args.mc)
    y = b.obs.simulate_measurements(gen_y, x)
    x, y = x[:, ::2].contiguous(), y[:, ::2].contiguous()
    rows, _ = run_filter_bank(b.algs, y, x, engine=args.engine)
    cols = (["rmse", "rmse_2std", "nci", "nll", "wallclock_s"]
            + (["engine"] if args.engine != "f64" else []))
    title = f"Reentry GPQ demo, dur={args.dur}s, mc={args.mc}, engine={args.engine}"
    print_tables(rows, title, columns=cols)
    return {title: rows}


if __name__ == "__main__":
    main()
