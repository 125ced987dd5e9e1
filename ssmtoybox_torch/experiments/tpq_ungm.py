"""UNGM heavy-tail study: UKF vs fully-symmetric Student vs TPQ Student filters.

``research/tpq/tpq_ungm.py:38-247``: UNGM whose process and measurement
noises are both 80/20 Gaussian mixtures ("glint"), comparing the UKF, the
fully-symmetric Student filter (FSQ) and t-process-quadrature Student
filters (TPQSF) for TP degrees of freedom 3, 10 and 500.  The TPQ weights
come from the Student-MC kernels (``csrc/student_qrq.cu``,
``csrc/student_mc.cu``) on the card.

Usage: python -m ssmtoybox_torch.experiments.tpq_ungm [--steps 250] [--mc 100]
           [--seed 0] [--tpq-samples 2000000] [--latex] [--device cuda|cpu]
"""
from types import SimpleNamespace

import numpy as np

from .. import ssinf
from ..ssmod import UNGMMeasurement, UNGMTransition
from ..utils import GaussianMixtureRV, GaussRV, StudentRV
from .common import device_of, generators, parser, print_tables, run_filter_bank

TP_DOFS = (3.0, 10.0, 500.0)


def parse(argv=None):
    ap = parser(__doc__, 0)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--mc", type=int, default=100)
    ap.add_argument("--tpq-samples", type=int, default=2_000_000,
                    help="MC samples for the Student kernel expectations")
    return ap.parse_args(argv)


def build(args):
    """The glint data system (``dyn_data``, ``obs_data``), the Student system
    and the five filters."""
    dev = device_of(args.device)
    # data-generating system (tpq_ungm.py:39-55): process glint N(0,10)/N(0,100),
    # measurement glint N(0,0.01)/N(0,1)
    zeros = (np.zeros(1), np.zeros(1))
    w8020 = np.array([0.8, 0.2])
    q_mix = GaussianMixtureRV(1, zeros, (10.0 * np.eye(1), 100.0 * np.eye(1)), w8020, device=dev)
    r_mix = GaussianMixtureRV(1, zeros, (0.01 * np.eye(1), 1.0 * np.eye(1)), w8020, device=dev)
    dyn_data = UNGMTransition(GaussRV(1, cov=1.0, device=dev), q_mix)
    obs_data = UNGMMeasurement(r_mix, dim_state=1)

    # Student system for the Student filters: moment-matched scales
    # (nu - 2) / nu * cov with nu = 4 (tpq_ungm.py:60-66); the UKF keeps the
    # nominal covariances; kappa = 0 point sets throughout (tpq_ungm.py:86-87)
    nu_ssm = 4.0
    mm = (nu_ssm - 2.0) / nu_ssm
    dyn_s = UNGMTransition(StudentRV(1, scale=mm * 1.0, dof=nu_ssm, device=dev),
                           StudentRV(1, scale=mm * 10.0, dof=nu_ssm, device=dev))
    obs_s = UNGMMeasurement(StudentRV(1, scale=mm * 0.01, dof=nu_ssm, device=dev), dim_state=1)
    # TPQ kernel parameters (tpq_ungm.py:77-78)
    par_dyn_tp = np.array([[3.0, 1.0]])
    par_obs_tp = np.array([[3.0, 3.0]])

    algs = {
        "UKF": ssinf.UnscentedKalman(
            UNGMTransition(GaussRV(1, cov=1.0, device=dev), GaussRV(1, cov=10.0, device=dev)),
            UNGMMeasurement(GaussRV(1, cov=0.01, device=dev), dim_state=1), kappa=0.0),
        "FSQ": ssinf.FullySymmetricStudent(dyn_s, obs_s, degree=3, kappa=0.0, dof=4.0),
    }
    for nu in TP_DOFS:
        # compat_drop_nu=False: the reference drops dof_tp on its way to the
        # TP model (bqmtran.py:271-272), which would make the three rows one;
        # the FUSION-2017 sweep is honoured instead
        algs[f"TPQSF-{int(nu)}"] = ssinf.StudentProcessStudent(
            dyn_s, obs_s, par_dyn_tp, par_obs_tp, point_par={"kappa": 0.0},
            dof=4.0, dof_tp=nu, compat_drop_nu=False,
            mc_opts={"num_samples": args.tpq_samples})
    return SimpleNamespace(device=dev, dyn_data=dyn_data, obs_data=obs_data, dyn_s=dyn_s,
                           obs_s=obs_s, algs=algs)


def main(argv=None):
    args = parse(argv)
    b = build(args)
    gen_x, gen_y = generators(b.device, args.seed, args.seed + 1)
    x = b.dyn_data.simulate_discrete(gen_x, steps=args.steps, mc_sims=args.mc)
    y = b.obs_data.simulate_measurements(gen_y, x)
    rows, _ = run_filter_bank(b.algs, y, x)
    title = f"UNGM glint noise, steps={args.steps}, mc={args.mc}"
    print_tables(rows, title, args.latex, ["rmse", "rmse_2std", "inc", "inc_2std", "wallclock_s"])
    return {title: rows}


if __name__ == "__main__":
    main()
