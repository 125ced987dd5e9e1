#!/usr/bin/env python3
"""CPU probes behind the parameters and tolerances of ``chip_smoke.py``'s
phase 21 ("bq_rest"): how far rounding carries on the UNGM lanes, the
conditioning of the theta gradient and of the GP fit, the RQ kernel's model
variance and the multi-output TP weights on the CV glint study.

    python3 tools/bq_rest_probes.py [--jax]

Runs the port on the CPU (``set_device("cpu")``), from the repository root,
in about two minutes on 8 cores; ``--jax`` also runs the JAX package's
Student filter on the port's MO-TP weights of the CV glint study.  Every
number printed is a CPU number.
"""
import argparse
import os
import sys
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (constants only)
import ssmtoybox_torch as stt  # noqa: E402
from ssmtoybox_torch.bq import GaussianProcessModel, GaussianProcessTransform  # noqa: E402
from ssmtoybox_torch.ssmod import (ConstantVelocity, Radar2DMeasurement,  # noqa: E402
                                   ReentryVehicle2DTransition, UNGMMeasurement,
                                   UNGMTransition)
from ssmtoybox_torch.utils import GaussianMixtureRV, GaussRV, StudentRV  # noqa: E402

FIELDS = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")


def err(a, b, steps=None):
    """The largest difference of two filter results over their first
    ``steps`` steps, relative to each stream's largest entry."""
    return max(float((getattr(a, f)[..., :steps] - getattr(b, f)[..., :steps]).abs().max()
                     / getattr(b, f)[..., :steps].abs().max()) for f in FIELDS)


def records(dyn, obs, runs, steps, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = dyn.simulate_discrete(gen, steps=steps, mc_sims=runs)
    return x.permute(2, 0, 1), obs.simulate_measurements(gen, x).permute(2, 0, 1)


def ungm():
    return (UNGMTransition(GaussRV(1, cov=5.0), GaussRV(1, cov=10.0)),
            UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1))


def ungm_prefix():
    dyn, obs = ungm()
    _, ys = records(dyn, obs, 200, 500)
    par = np.array(cs.RQ_UNGM)
    alg = stt.GaussianProcessKalman(dyn, obs, par, par, kernel="rq")
    dd, eager = alg.forward_pass_batch(ys, engine="dd"), alg.forward_pass_batch(ys, engine="f64")
    print("GPQ-RQ UNGM, 200 runs, fused (plain version) vs eager: "
          + ", ".join(f"{n} steps {err(dd, eager, n):.2e}" for n in (20, 50, 100, 500)))
    _, ys = records(dyn, obs, 10_000, 50, seed=1)
    kp = np.array(cs.THETA_GPQ)
    mo = stt.MultiOutputGaussianProcessKalman(dyn, obs, kp, kp)
    so = stt.GaussianProcessKalman(dyn, obs, kp, kp)
    w = max(float((a - b.reshape(a.shape)).abs().max() / a.abs().max()) for a, b in (
        (so.tf_dyn.wm, mo.tf_dyn.wm), (so.tf_dyn.Wc, mo.tf_dyn.Wc), (so.tf_dyn.Wcc, mo.tf_dyn.Wcc)))
    r_mo, r_so = mo.forward_pass_batch(ys), so.forward_pass_batch(ys, engine="f64")
    print(f"MO-GPQKF vs GPQKF, UNGM, 10,000 runs: weights {w:.2e}; "
          + ", ".join(f"{n} steps {err(r_mo, r_so, n):.2e}" for n in (1, 5, 50)))


def theta_gradient():
    dyn, obs = ungm()
    xs, ys = records(dyn, obs, 2000, 100, seed=2)
    alg = stt.GaussianProcessKalman(dyn, obs, np.array(cs.THETA_GPQ), np.array(cs.THETA_GPQ))

    def grad(n, rel):
        lt = torch.log(torch.tensor(cs.THETA_GPQ_2, dtype=torch.float64) * (1 + rel))
        a, b = lt.clone().requires_grad_(True), lt.clone().requires_grad_(True)
        res = stt.gaussian_filter(dyn, obs, alg.tf_dyn, alg.tf_obs, ys[..., :n],
                                  theta_dyn=a.exp(), theta_obs=b.exp())
        var = res.fi_cov[:, 0]
        nll = 0.5 * torch.mean((res.fi_mean - xs[..., :n]) ** 2 / var
                               + torch.log(2 * np.pi * var))
        return torch.cat([g.reshape(-1) for g in torch.autograd.grad(nll, (a, b))])

    for n in (10, 100):
        g0, g1 = grad(n, 0.0), grad(n, 1e-15)
        print(f"theta gradient, GPQKF on UNGM, 2,000 runs x {n} steps: theta x (1 + 1e-15) "
              f"moves it by {float((g1 - g0).abs().max() / g0.abs().max()):.2e} of its largest "
              "entry")


def gp_optimize():
    dyn, _ = ungm()
    gen = torch.Generator().manual_seed(cs.SEED + 23)
    x = 20.0 * torch.rand(1, cs.OPT_POINTS, generator=gen, dtype=torch.float64) - 10.0
    y = dyn.dyn_eval(x.T, 0)
    gp = GaussianProcessModel(1, [[1.0, 1.0]], "rbf", "ut")
    a = gp.optimize(np.log([10.0, 2.0]), y, x)
    b = gp.optimize(np.log([10.0, 2.0]), y * (1 + 1e-14), x)
    K = gp.kernel.eval(torch.exp(torch.tensor(a.x)), x)
    print(f"GP optimize, {cs.OPT_POINTS} points: {a.message}; a 1e-14 change of the data moves "
          f"the optimum by {np.abs(a.x - b.x).max():.2e} in log parameters; Gram condition at "
          f"the optimum {float(torch.linalg.cond(K)):.2e}")


def rq():
    rows = []
    for alpha in (1.0, 10.0, 100.0, 1e3, 1e4):
        mv = [float(GaussianProcessTransform(d, d, np.array([[1.0, alpha] + [ell] * d]),
                                             "rq").model_var)
              for d, ell in ((1, 1.0), (1, 3.0), (5, 3.0), (5, 10.0))]
        rows.append(f"alpha {alpha:g}: " + ", ".join(f"{v:.3g}" for v in mv))
    print("RQ expected model variance on UT points (l = 1 and 3 in 1-D, 3 and 10 in 5-D): "
          + "; ".join(rows))
    dyn = ReentryVehicle2DTransition(
        GaussRV(5, mean=np.array([6500.4, 349.14, -1.8093, -6.7967, 0.6932]),
                cov=np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0])),
        GaussRV(3, cov=np.diag([2.4064e-5, 2.4064e-5, 1e-6])), dt=0.05)
    obs = Radar2DMeasurement(GaussRV(2, cov=np.diag([1e-3, 1e-5])), dim_state=5,
                             state_index=[0, 1], radar_loc=np.array([6374.0, 0.0]))
    _, ys = records(dyn, obs, 200, 100, seed=3)
    out = []
    for alpha in (1e3, 1e4):
        par = np.array([[1.0, alpha] + [10.0] * 5])
        res = stt.GaussianProcessKalman(dyn, obs, par, par, kernel="rq").forward_pass_batch(
            ys, engine="f64")
        out.append(f"alpha {alpha:g} "
                   f"{float(torch.isfinite(res.fi_mean).all(-1).all(-1).double().mean()):.0%}")
    print("GPQKF-RQ on reentry (l = 10), finite runs of 200: " + ", ".join(out))


def mo_tp_cv(with_jax: bool):
    P0, sc = np.diag(cs.P0), (cs.X0_DOF - 2.0) / cs.X0_DOF
    dyn_t = ConstantVelocity(GaussRV(4, mean=cs.M0_TRUE, cov=P0), GaussRV(2, cov=np.diag(cs.Q)),
                             dt=cs.DT)
    glint = GaussianMixtureRV(2, means=(np.zeros(2), np.zeros(2)),
                              covs=(np.diag(cs.R0), np.diag(cs.R1)), alphas=(0.85, 0.15))
    xs, ys = records(dyn_t, Radar2DMeasurement(glint, dim_state=4, state_index=cs.SIDX), 200,
                     cs.CV_STEPS, seed=4)
    dyn = ConstantVelocity(StudentRV(4, mean=cs.M0_MIS, scale=sc * P0, dof=cs.X0_DOF),
                           StudentRV(2, scale=sc * np.diag(cs.Q), dof=cs.X0_DOF), dt=cs.DT)
    obs = Radar2DMeasurement(StudentRV(2, scale=(cs.R_DOF - 2.0) / cs.R_DOF * np.diag(cs.R0),
                                       dof=cs.R_DOF), dim_state=4, state_index=cs.SIDX)
    pd, po = np.tile(cs.PAR_DYN, (4, 1)), np.tile(cs.PAR_OBS, (2, 1))
    opts = {"num_samples": 200_000}
    mo = stt.MultiOutputStudentProcessStudent(dyn, obs, pd, po, point_par={"kappa": 0.0},
                                              mc_opts=opts)
    so = stt.StudentProcessStudent(dyn, obs, pd[:1], po[:1], point_par={"kappa": 0.0},
                                   mc_opts=opts)
    gap = lambda wm, Wc: float(Wc.sum() - wm.sum() ** 2)  # noqa: E731
    print(f"MO-TP weights, CV glint dynamics rule, 2e5 samples: 1' Wc 1 - (1' wm)^2 "
          f"{gap(mo.tf_dyn.wm[:, 0], mo.tf_dyn.Wc[:, :, 0, 0]):.2e} composed, "
          f"{gap(so.tf_dyn.wm, so.tf_dyn.Wc):.2e} through projected_weight_stats")
    res = mo.forward_pass_batch(ys)
    ok = torch.isfinite(res.fi_mean).all(-1).all(-1)
    print(f"MO-TP Student filter, CV glint, 200 runs x {cs.CV_STEPS} steps: "
          f"{int((~ok).sum())} runs not finite")
    if with_jax:
        jax_cv_glint(mo, ys[:4])


def jax_cv_glint(mo, ys):
    """The JAX package's Student filter on the port's MO-TP weights."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import ssmtoybox_tpu as st
    from ssmtoybox_tpu import ssmod as js
    from ssmtoybox_tpu.bq.models import StudentTProcessMO
    from ssmtoybox_tpu.bq.transforms import MultiOutputStudentTProcessTransform
    from ssmtoybox_tpu.utils import StudentRV as JStudentRV

    P0, sc = np.diag(cs.P0), (cs.X0_DOF - 2.0) / cs.X0_DOF
    jd = js.ConstantVelocity.create(
        JStudentRV.create(4, mean=np.array(cs.M0_MIS), scale=sc * P0, dof=cs.X0_DOF),
        JStudentRV.create(2, scale=sc * np.diag(cs.Q), dof=cs.X0_DOF), dt=cs.DT)
    jo = js.Radar2DMeasurement.create(
        JStudentRV.create(2, scale=(cs.R_DOF - 2.0) / cs.R_DOF * np.diag(cs.R0), dof=cs.R_DOF),
        dim_state=4, state_index=cs.SIDX)
    tfs = []
    for tf, par, dof in ((mo.tf_dyn, cs.PAR_DYN, cs.X0_DOF), (mo.tf_obs, cs.PAR_OBS, cs.R_DOF)):
        model = StudentTProcessMO.create(4, tf.dim_out, np.tile(par, (tf.dim_out, 1)), "rbf",
                                         "fs", {"kappa": 0.0, "dof": dof}, nu=tf.nu)
        tfs.append(MultiOutputStudentTProcessTransform(
            model=model, dim_out=tf.dim_out,
            **{k: getattr(tf, k).numpy() for k in ("wm", "Wc", "Wcc", "Q", "iK")}))
    out = jax.jit(jax.vmap(lambda d: st.ssinf.studentian_filter(jd, jo, *tfs, d, 4.0, True)))(
        jnp.asarray(ys.numpy()))
    bad = int((~np.isfinite(np.asarray(out.fi_mean)).all(axis=(1, 2))).sum())
    print(f"the JAX package's Student filter on the same weights: {bad} of {ys.shape[0]} runs "
          "not finite")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax", action="store_true",
                    help="also run the JAX package's filter on the MO-TP weights")
    args = ap.parse_args()
    stt.set_device("cpu")
    warnings.simplefilter("ignore", RuntimeWarning)
    ungm_prefix()
    theta_gradient()
    gp_optimize()
    rq()
    mo_tp_cv(args.jax)


if __name__ == "__main__":
    main()
