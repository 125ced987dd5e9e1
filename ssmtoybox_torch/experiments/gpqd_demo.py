"""GPQ with derivatives (the MLSP-2016 line of work).

``research/gpqd/mlsp2016_demo.py`` (GPQ vs GPQ+D transform accuracy on
``sin(x) + x^2 / 2`` against 200,000-sample Monte-Carlo moments) and
``research/gpqd/hybrid_demo.py`` (the EKF vs the single-point GPQ+D filter
``ExtendedKalmanGPQD`` on UNGM).  Every filter here runs eagerly: the fused
engines refuse GPQ+D and linearization.

Usage: python -m ssmtoybox_torch.experiments.gpqd_demo [--steps 100] [--mc 50]
           [--seed 0] [--device cuda|cpu]
"""
from types import SimpleNamespace

import numpy as np
import torch

from .. import ssinf
from ..bq.gpqd import GaussianProcessDerTransform
from ..bq.transforms import GaussianProcessTransform
from ..ssmod import UNGMMeasurement, UNGMTransition
from ..utils import GaussRV, symmetrized_kl_divergence
from .common import device_of, generators, parser, print_tables, run_filter_bank

#: Monte-Carlo samples of the transform study's truth
TRUTH_SAMPLES = 200_000


def sin_quad(x, time):
    """The transform study's integrand ``sin(x) + x^2 / 2``."""
    return torch.sin(x) + 0.5 * x ** 2


def parse(argv=None):
    ap = parser(__doc__, 0, latex=False)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mc", type=int, default=50)
    return ap.parse_args(argv)


def build(args):
    """The two transforms with their input moments (``mean``, ``cov``), the
    UNGM models and the EKF and EKF-GPQD."""
    dev = device_of(args.device)
    kpar = np.array([[1.0, 1.5]])
    transforms = {
        "GPQ": GaussianProcessTransform(1, 1, kpar, point_str="ut", device=dev),
        "GPQ+D": GaussianProcessDerTransform(1, 1, kpar, point_str="ut", device=dev),
    }
    mean = torch.tensor([0.5], dtype=torch.float64, device=dev)
    cov = torch.tensor([[0.8]], dtype=torch.float64, device=dev)
    dyn = UNGMTransition(GaussRV(1, cov=5.0, device=dev), GaussRV(1, cov=10.0, device=dev))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=1)
    rbf_par = np.array([[1.0, 3.0]])
    algs = {
        "EKF": ssinf.ExtendedKalman(dyn, obs),
        "EKF-GPQD": ssinf.ExtendedKalmanGPQD(dyn, obs, rbf_par, rbf_par),
    }
    return SimpleNamespace(device=dev, transforms=transforms, mean=mean, cov=cov, dyn=dyn,
                           obs=obs, algs=algs)


def main(argv=None):
    args = parse(argv)
    b = build(args)
    gen_t, gen_x, gen_y = generators(b.device, args.seed, args.seed + 1, args.seed + 2)
    tables = {}

    # ---- transform level: GPQ vs GPQ+D on a scalar nonlinearity ----------
    xs = b.mean + torch.sqrt(b.cov[0, 0]) * torch.randn(
        TRUTH_SAMPLES, 1, generator=gen_t, dtype=torch.float64, device=b.device)
    fs = sin_quad(xs, None)
    mean_mc = fs.mean(0)
    cov_mc = torch.atleast_2d(torch.var(fs, dim=0, correction=0))
    rows = {}
    for name, tf in b.transforms.items():
        mf, cf, _ = tf.apply(sin_quad, b.mean, b.cov, None)
        rows[name] = {"mean_err": float((mf - mean_mc).abs()[0]),
                      "skl": float(symmetrized_kl_divergence(mean_mc, cov_mc, mf, cf))}
    title = "GPQ vs GPQ+D transform (sin + quadratic)"
    tables[title] = rows
    print_tables(rows, title)

    # ---- filter level: EKF vs ExtendedKalmanGPQD on UNGM (hybrid_demo) ---
    x = b.dyn.simulate_discrete(gen_x, steps=args.steps, mc_sims=args.mc)
    y = b.obs.simulate_measurements(gen_y, x)
    bank, _ = run_filter_bank(b.algs, y, x)
    title = f"EKF vs EKF-GPQD on UNGM, steps={args.steps}, mc={args.mc}"
    tables[title] = bank
    print_tables(bank, title, columns=["rmse", "rmse_2std", "nci", "nll"])
    return tables


if __name__ == "__main__":
    main()
