"""Constant-velocity radar tracking with glint (outlier) measurement noise.

The FUSION-2017 study ``research/tpq/tpq_constant_velocity.py`` with the
reference's system geometry, as the JAX package's script sets it out:

- truth: CV dynamics (``dt = 0.5``) with process noise
  ``q ~ N(0, diag([50, 5]))`` through the model's noise gain; initial state
  ``N([10000, 300, 1000, -40], diag([100^2, 10^2, 100^2, 10^2]))``;
- radar measurements of the sub-state ``state_index=[0, 2, 1, 3]`` with
  glint noise ``0.85 N(0, R0) + 0.15 N(0, R1)``, ``R0 = diag([50, 0.4e-6])``,
  ``R1 = diag([5000, 1.6e-5])``;
- filters from the mismatched mean ``[10175, 295, 980, -35]``; the Student
  system with ``x0_dof = 1000`` moment-matched scales and an ``r_dof = 4``
  nominal-noise scale;
- TPQSF / GPQSF kernel parameters ``[[0.05, 100 x 4]]`` and
  ``[[0.005, 10, 100, 10, 100]]``, ``kappa = 0``, the Student-kernel BQ
  weights from ``--mc-weights`` Monte-Carlo samples through the Student-MC
  kernels (``csrc/student_qrq.cu``, ``csrc/student_mc.cu``) on the card.

The square-root FSQ row runs in float32 (factor form, PD by construction)
and is cast to float64 for scoring; its time includes the factor-to-
covariance product and the cast.

Usage: python -m ssmtoybox_torch.experiments.tpq_constant_velocity [--steps 100]
           [--mc 100] [--seed 0] [--mc-weights 2000000] [--latex] [--device cuda|cpu]
"""
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from .. import ssinf
from ..sqrt import SquareRootStudent
from ..ssmod import ConstantVelocity, Radar2DMeasurement
from ..utils import GaussianMixtureRV, GaussRV, StudentRV
from .common import (aggregate, device_of, generators, parser, print_tables, run_filter_bank,
                     study_scores)

DT = 0.5
P0 = np.diag([100.0 ** 2, 10.0 ** 2, 100.0 ** 2, 10.0 ** 2])
Q = np.diag([50.0, 5.0])
R0 = np.diag([50.0, 0.4e-6])
R1 = np.diag([5000.0, 1.6e-5])
SIDX = [0, 2, 1, 3]
M0_TRUE = [10000., 300., 1000., -40.]
M0_MIS = [10175., 295., 980., -35.]
X0_DOF, R_DOF = 1000.0, 4.0
#: TPQ / GPQ kernel parameters (tpq_constant_velocity.py:62-68)
PAR_DYN = [[0.05, 100., 100., 100., 100.]]
PAR_OBS = [[0.005, 10., 100., 10., 100.]]


@dataclass
class BankResult:
    """The moments the bank scores: (M, D, N) and (M, D, D, N)."""

    fi_mean: torch.Tensor
    fi_cov: torch.Tensor


@dataclass
class SqrtStudentAdapter:
    """A square-root Student filter in the bank: ``forward_pass_batch``
    returns the moments as a :class:`BankResult` in float64."""

    alg: SquareRootStudent

    def forward_pass_batch(self, ys):
        m, c = self.alg.forward_pass_batch(ys)
        return BankResult(fi_mean=m.to(torch.float64), fi_cov=c.to(torch.float64))


def parse(argv=None):
    ap = parser(__doc__, 0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mc", type=int, default=100)
    ap.add_argument("--mc-weights", type=int, default=int(2e6),
                    help="samples for the Student-kernel MC weight sweep")
    return ap.parse_args(argv)


def build(args):
    """The truth system (``dyn_true``, ``obs_true``), the Gaussian and
    Student filter systems and the five filters."""
    dev = device_of(args.device)
    x0_true = GaussRV(4, mean=np.array(M0_TRUE), cov=P0, device=dev)
    dyn_true = ConstantVelocity(x0_true, GaussRV(2, cov=Q, device=dev), dt=DT)
    r_glint = GaussianMixtureRV(2, means=(np.zeros(2), np.zeros(2)), covs=(R0, R1),
                                alphas=(0.85, 0.15), device=dev)
    obs_true = Radar2DMeasurement(r_glint, dim_state=4, state_index=SIDX)

    # filter systems: mismatched init, nominal (outlier-free) noise model
    m0 = np.array(M0_MIS)
    dyn_g = ConstantVelocity(GaussRV(4, mean=m0, cov=P0, device=dev),
                             GaussRV(2, cov=Q, device=dev), dt=DT)
    obs_g = Radar2DMeasurement(GaussRV(2, cov=R0, device=dev), dim_state=4, state_index=SIDX)
    sc = (X0_DOF - 2) / X0_DOF
    dyn_s = ConstantVelocity(StudentRV(4, mean=m0, scale=sc * P0, dof=X0_DOF, device=dev),
                             StudentRV(2, scale=sc * Q, dof=X0_DOF, device=dev), dt=DT)
    obs_s = Radar2DMeasurement(StudentRV(2, scale=((R_DOF - 2) / R_DOF) * R0, dof=R_DOF,
                                         device=dev), dim_state=4, state_index=SIDX)

    par_dyn, par_obs = np.array(PAR_DYN), np.array(PAR_OBS)
    kappa = {"kappa": 0.0}
    mc_opts = {"num_samples": args.mc_weights}
    algs = {
        "UKF": ssinf.UnscentedKalman(dyn_g, obs_g, kappa=0.0),
        "FSQ": ssinf.FullySymmetricStudent(dyn_s, obs_s, degree=3, kappa=0.0, dof=4.0),
        "SR-FSQ (f32)": SqrtStudentAdapter(SquareRootStudent(
            dyn_s, obs_s, degree=3, kappa=0.0, dof=4.0, dtype=torch.float32)),
        "TPQSF(nu=4)": ssinf.StudentProcessStudent(
            dyn_s, obs_s, par_dyn, par_obs, point_par=kappa, dof=4.0, dof_tp=4.0,
            mc_opts=mc_opts),
        "GPQSF": ssinf.GPQStudent(dyn_s, obs_s, par_dyn, par_obs, point_hyp=kappa, dof=4.0,
                                  mc_opts=mc_opts),
    }
    return SimpleNamespace(device=dev, dyn_true=dyn_true, obs_true=obs_true, dyn_g=dyn_g,
                           obs_g=obs_g, dyn_s=dyn_s, obs_s=obs_s, algs=algs)


def main(argv=None):
    args = parse(argv)
    b = build(args)
    gen_x, gen_y = generators(b.device, args.seed, args.seed + 1)
    x = b.dyn_true.simulate_discrete(gen_x, steps=args.steps, mc_sims=args.mc)
    y = b.obs_true.simulate_measurements(gen_y, x)
    rows, raw = run_filter_bank(b.algs, y, x)
    tables = {}
    title = f"CV radar + 15% glint, steps={args.steps}, mc={args.mc}"
    tables[title] = rows
    print_tables(rows, title, args.latex, ["rmse", "rmse_2std", "inc", "inc_2std", "diverged",
                                           "wallclock_s"])

    # position / velocity splits (tpq_constant_velocity.py:108-112)
    for label, ix in (("position", [0, 2]), ("velocity", [1, 3])):
        split = {}
        for name, (res, _) in raw.items():
            s = study_scores(x[ix], res.fi_mean[:, ix], res.fi_cov[:, ix][:, :, ix])
            split[name] = aggregate(s, spread=False)
        title = f"CV glint {label} scores"
        tables[title] = split
        print_tables(split, title, args.latex, ["rmse", "inc"])
    return tables


if __name__ == "__main__":
    main()
