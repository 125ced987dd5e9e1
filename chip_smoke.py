#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ssmtoybox_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (PATH, $CUDA_HOME or /usr/local/cuda); it
fails at once without them.  Phases, each fatal on failure:

1. set-up: print the card's name and power limit, build the CUDA sources
   ``ssmtoybox_torch/csrc/scalar_filter.cu`` and ``student_mc.cu`` for
   sm_90a (one nvcc each, at once) and print their ptxas lines;
2. the scalar filter kernel vs its plain PyTorch twin, both on the card, for
   the UKF and the GPQ rule: one step at B=4096 (pointwise 1e-13), 20 steps
   at B=4096 (pointwise 1e-9), and study RMSE at B=10,000 x 500 steps
   (relative 1e-3; the UNGM map decorrelates single trajectories);
3. the port against the repo's golden references (tests/goldens) on the card;
4. the Gaussian main path at the study sizes: 10,000 trajectories in
   float64, UNGM UKF and GPQKF through the kernel (``engine="dd"``), reentry
   UKF through the eager batched path, then the RTS smoother and RMSE;
5. timings with CUDA events after a warm-up;
6. the four RBF-Student Monte-Carlo kernels vs their plain versions on the
   same samples, at the CV radar glint study's shapes (D = 4, the 9 points of
   the TPQSF dynamics rule, 2e6 samples): q, R, Q and E[k(x, y)] within 1e-5
   relative, the backward kernels' gradients against autograd through the
   plain versions at rtol 1e-4 / atol 1e-5; their timings;
7. Student goldens on the card: FSQ on ``ungm_student.npz`` (1e-8) and the
   TP weights at 2e6 samples on ``tpq_cv_weights.npz`` (the tolerances and
   eigenvalue check of ``tests/test_parity.py``);
8. the Student-t BQ path at full width: the CV radar glint study, 10,000
   trajectories x 100 steps simulated on the card, TPQSF, GPQSF and FSQ built
   on the card (weights from 2e6 samples), filter and smoother of each, RMSE,
   INC and the diverged share, with the launch counts of the four kernels;
   then the timings of the weights, filters and smoothers.

The line before the last two is a JSON object describing each kernel; the
line before the last is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

MC = 10_000
UNGM_STEPS = 500
REENTRY_STEPS = 100
COMPARE_B = 4096
SEED = 0


def log(*a):
    print(*a, flush=True)


def fail(msg):
    log(f"FAILED: {msg}")
    sys.exit(1)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=5):
    """Median and min wall time of ``fn`` on the card in ms, CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    return times[len(times) // 2], times[0]


#: the CV radar glint study (experiments/tpq_constant_velocity.py)
CV_STEPS = 100
STUDENT_MC = 2_000_000
DT = 0.5
P0 = [100.0 ** 2, 10.0 ** 2, 100.0 ** 2, 10.0 ** 2]
Q = [50.0, 5.0]
R0, R1 = [50.0, 0.4e-6], [5000.0, 1.6e-5]
SIDX = [0, 2, 1, 3]
M0_TRUE = [10000.0, 300.0, 1000.0, -40.0]
M0_MIS = [10175.0, 295.0, 980.0, -35.0]
X0_DOF, R_DOF = 1000.0, 4.0
PAR_DYN = [[0.05, 100.0, 100.0, 100.0, 100.0]]
PAR_OBS = [[0.005, 10.0, 100.0, 10.0, 100.0]]
#: the seed of the golden TP-weight check (the MC spread is seed-dependent, PERF.md)
GOLDEN_SEED = 0


def rel_err(a, b) -> float:
    """``max |a - b| / max |b|``."""
    return float((a - b).abs().max() / b.abs().max())


def study_scores(torch, x_true, fi_mean, fi_cov):
    """Per-run RMSE, INC and NLL as the JAX package's study harness computes
    them (experiments/common.py): the per-step MSE matrix is taken over the
    runs whose RMSE is finite.  ``x_true``/``fi_mean`` (M, D, N), ``fi_cov``
    (M, D, D, N)."""
    from ssmtoybox_torch.utils.metrics import log_cred_ratio, neg_log_likelihood
    err = fi_mean - x_true
    rmse = torch.sqrt(torch.mean(torch.sum(err ** 2, 1), -1))
    finite = torch.isfinite(rmse)
    err_ok = torch.where(finite[:, None, None], err, 0.0)
    M, D, N = err.shape
    MSE = (torch.einsum("mdn,men->nde", err_ok, err_ok) / finite.sum().clamp(min=1)
           + 1e-12 * torch.eye(D, dtype=err.dtype, device=err.device))
    x, m = x_true.permute(0, 2, 1), fi_mean.permute(0, 2, 1)
    P = fi_cov.permute(0, 3, 1, 2)
    lcr = log_cred_ratio(x, m, P, MSE.expand(M, N, D, D))
    return rmse, lcr.mean(1), neg_log_likelihood(x, m, P).mean(1)


def student_slice(torch, np, dev):
    """Phases 6-8: the Student-t BQ path and its four kernels.  Returns the
    kernels' entries of the ``kernels`` line."""
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.bq import StudentTProcessTransform
    from ssmtoybox_torch.ops import student_mc as smc
    from ssmtoybox_torch.points import fs_points
    from ssmtoybox_torch.ssmod import (ConstantVelocity, Radar2DMeasurement, UNGMMeasurement,
                                       UNGMTransition)
    from ssmtoybox_torch.utils import GaussianMixtureRV, GaussRV, StudentRV, rand

    f64 = dict(dtype=torch.float64, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    # ---- 6. the four kernels vs their plain versions, study shapes --------
    par = torch.tensor(PAR_DYN, **f64)
    x = torch.as_tensor(fs_points(4, 3, 0.0, X0_DOF), **f64)      # TPQSF dynamics rule
    gen = torch.Generator(device=dev).manual_seed(SEED)
    c_q, _, tot_q = smc.chunking(STUDENT_MC, smc.QRQ_CHUNK)
    c_k, _, tot_k = smc.chunking(STUDENT_MC, smc.KXY_CHUNK)
    s_q = rand.multivariate_t(gen, torch.zeros(4, **f32), torch.eye(4, **f32), 4.0, (tot_q,))
    s_k = rand.multivariate_t(gen, torch.zeros(4, **f32), torch.eye(4, **f32), 4.0, (tot_k,))
    d, n = x.shape
    err = {}
    got, ref = smc.student_qrq(par, x, s_q, c_q), smc.student_qrq_plain(par, x, s_q, c_q)
    torch.cuda.synchronize()
    rels = [rel_err(a, b) for a, b in zip(got, ref)]
    err["qrq"] = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    log(f"qrq kernel vs plain ({tot_q} samples, chunk {c_q}, D={d}, N={n}): relative "
        f"q {rels[0]:.2e}, R {rels[1]:.2e}, Q {rels[2]:.2e} (limit 1e-5)")
    if not max(rels) < 1e-5:
        fail(f"qrq kernel vs plain: relative {max(rels):.3e} exceeds 1e-5")
    v, vr = smc.student_kxy(par, s_k, c_k), smc.student_kxy_plain(par, s_k, c_k)
    err["kxy"] = abs(float(v) - float(vr))
    log(f"kxy kernel vs plain ({tot_k} samples, chunk {c_k}): {float(v):.12f} vs "
        f"{float(vr):.12f}, relative {err['kxy'] / abs(float(vr)):.2e} (limit 1e-5)")
    if not err["kxy"] / abs(float(vr)) < 1e-5:
        fail("kxy kernel vs plain exceeds 1e-5 relative")

    wgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    w = [torch.randn(s, generator=wgen, **f64) for s in ((n,), (d, n), (n, n))]

    def grads(fn):
        p, xx = par.clone().requires_grad_(True), x.clone().requires_grad_(True)
        loss = sum(torch.sum(wi * oi) for wi, oi in zip(w, fn(p, xx, s_q, c_q)))
        return torch.autograd.grad(loss, (p, xx))

    for tag, g_k, g_p in (("qrq_bwd", grads(smc.student_qrq), grads(smc.student_qrq_plain)),):
        err[tag] = max(float((a - b).abs().max()) for a, b in zip(g_k, g_p))
        ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-5) for a, b in zip(g_k, g_p))
        log(f"{tag} gradient vs autograd through the plain version: max |diff| "
            f"{err[tag]:.2e}, relative {max(rel_err(a, b) for a, b in zip(g_k, g_p)):.2e} "
            f"(rtol 1e-4, atol 1e-5)")
        if not ok:
            fail(f"{tag} gradient disagrees with autograd through the plain version")
    p_k, p_p = par.clone().requires_grad_(True), par.clone().requires_grad_(True)
    (g_k,) = torch.autograd.grad(smc.student_kxy(p_k, s_k, c_k), p_k)
    (g_p,) = torch.autograd.grad(smc.student_kxy_plain(p_p, s_k, c_k), p_p)
    err["kxy_bwd"] = float((g_k - g_p).abs().max())
    log(f"kxy_bwd gradient vs autograd through the plain version: max |diff| "
        f"{err['kxy_bwd']:.2e}, relative {rel_err(g_k, g_p):.2e} (rtol 1e-4, atol 1e-5)")
    if not torch.allclose(g_k, g_p, rtol=1e-4, atol=1e-5):
        fail("kxy_bwd gradient disagrees with autograd through the plain version")

    _, inv_l, xp = smc._kernel_args(par, x)
    gq, gR, gQ = (t.to(torch.float32).contiguous() for t in w)
    gQ2 = (gQ + gQ.T).contiguous()
    timed = {
        "qrq": (lambda: smc.qrq_sums(inv_l, s_q, xp, c_q),
                lambda: smc._qrq_partials_plain(inv_l, s_q, xp, c_q).double().sum(0)),
        "qrq_bwd": (lambda: smc.qrq_bwd_sums(inv_l, s_q, xp, gq, gR, gQ2, c_q),
                    lambda: smc._qrq_bwd_partials_plain(inv_l, s_q, xp, gq, gR, gQ2,
                                                        c_q).double().sum(0)),
        "kxy": (lambda: smc.kxy_chunk_sums(inv_l, s_k, c_k),
                lambda: smc._kxy_partials_plain(inv_l, s_k, c_k).double()),
        "kxy_bwd": (lambda: smc.kxy_bwd_sums(inv_l, s_k, c_k),
                    lambda: smc._kxy_bwd_partials_plain(inv_l, s_k, c_k).double().sum(0)),
    }
    ms = {}
    for name, (kern, plain) in timed.items():
        a, b = kern(), plain()
        ms[name] = cuda_ms(torch, kern)[0], cuda_ms(torch, plain)[0]
        log(f"{name}: kernel {ms[name][0]:.3f} ms, plain {ms[name][1]:.3f} ms "
            f"(wrapper sums, f64; kernel vs plain relative {rel_err(a, b):.2e})")
    del s_q, s_k

    # ---- 7. Student goldens on the card ----------------------------------
    g = np.load(os.path.join(HERE, "tests", "goldens", "ungm_student.npz"))
    dyn_u = UNGMTransition(StudentRV(1, scale=1.0, dof=4.0, device=dev),
                           StudentRV(1, scale=10.0, dof=4.0, device=dev))
    obs_u = UNGMMeasurement(StudentRV(1, scale=0.01, dof=4.0, device=dev), dim_state=1)
    for name, fixed in (("fsq3", True), ("fsq3_inc", False)):
        fm, fP = stt.FullySymmetricStudent(dyn_u, obs_u, degree=3, dof=4.0,
                                           fixed_dof=fixed).forward_pass(
            torch.as_tensor(g["y"][..., 0], device=dev))
        for got_, key in ((fm, "fm"), (fP, "fP")):
            if not np.allclose(got_.cpu().numpy(), g[f"{name}_{key}"], atol=1e-8, rtol=1e-8):
                fail(f"golden ungm_student {name}_{key} off by "
                     f"{np.abs(got_.cpu().numpy() - g[f'{name}_{key}']).max():.3e}")
    g = np.load(os.path.join(HERE, "tests", "goldens", "tpq_cv_weights.npz"))
    for tag in ("dyn", "obs"):
        for seed in range(4):
            t = StudentTProcessTransform(4, 1, g[f"{tag}_par"], "rbf-student", "fs",
                                         point_par={"dof": 4.0}, nu=4.0, device=dev,
                                         mc_opts={"num_samples": STUDENT_MC, "seed": seed})
            lam = np.linalg.eigvalsh(t.Wc.cpu().numpy())
            lam_ref = np.linalg.eigvalsh(g[f"{tag}_Wc"])
            e = {"wm": (np.abs(t.wm.cpu().numpy() - g[f"{tag}_wm"]).max(), 5e-3),
                 "Wc": (np.abs(t.Wc.cpu().numpy() - g[f"{tag}_Wc"]).max(), 0.5),
                 "Wcc": (np.abs(t.Wcc.cpu().numpy() - g[f"{tag}_Wcc"]).max(), 0.25),
                 "emv": (abs(float(t.model_var) / float(g[f"{tag}_emv"][0]) - 1.0), 0.3)}
            ok = all(v_ <= lim for v_, lim in e.values())
            ok = ok and lam[0] > -1e-10 and lam[-1] < 2.0 * lam_ref[-1]
            log(f"TP weights on the card vs golden, {tag}, seed {seed}: "
                + ", ".join(f"{k_} {v_:.3g} (limit {lim})" for k_, (v_, lim) in e.items())
                + f", eig [{lam[0]:.3g}, {lam[-1]:.3g}] (ref max {lam_ref[-1]:.3g}): "
                + ("ok" if ok else "OUTSIDE"))
            if seed == GOLDEN_SEED and not ok:
                fail(f"TP weights ({tag}, seed {seed}) outside the golden's tolerances")
    log("Student goldens on the card: FSQ (1e-8) and TP weights ok")

    # ---- 8. the Student-t BQ path: CV radar glint, 10,000 x 100 ------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dyn_t = ConstantVelocity(GaussRV(4, mean=M0_TRUE, cov=np.diag(P0), device=dev),
                             GaussRV(2, cov=np.diag(Q), device=dev), dt=DT)
    glint = GaussianMixtureRV(2, means=(np.zeros(2), np.zeros(2)),
                              covs=(np.diag(R0), np.diag(R1)), alphas=(0.85, 0.15), device=dev)
    obs_t = Radar2DMeasurement(glint, dim_state=4, state_index=SIDX)
    x_cv = dyn_t.simulate_discrete(gen, steps=CV_STEPS, mc_sims=MC)
    y_cv = obs_t.simulate_measurements(gen, x_cv)
    xs, ys = x_cv.permute(2, 0, 1), y_cv.permute(2, 0, 1)
    sc = (X0_DOF - 2.0) / X0_DOF
    dyn_s = ConstantVelocity(StudentRV(4, mean=M0_MIS, scale=sc * np.diag(P0), dof=X0_DOF,
                                       device=dev),
                             StudentRV(2, scale=sc * np.diag(Q), dof=X0_DOF, device=dev), dt=DT)
    obs_s = Radar2DMeasurement(StudentRV(2, scale=(R_DOF - 2.0) / R_DOF * np.diag(R0),
                                         dof=R_DOF, device=dev), dim_state=4, state_index=SIDX)
    makers = {
        "TPQSF": lambda: stt.StudentProcessStudent(
            dyn_s, obs_s, np.array(PAR_DYN), np.array(PAR_OBS), point_par={"kappa": 0.0},
            dof=4.0, dof_tp=4.0, mc_opts={"num_samples": STUDENT_MC}),
        "GPQSF": lambda: stt.GPQStudent(
            dyn_s, obs_s, np.array(PAR_DYN), np.array(PAR_OBS), point_hyp={"kappa": 0.0},
            dof=4.0, mc_opts={"num_samples": STUDENT_MC}),
        "FSQ": lambda: stt.FullySymmetricStudent(dyn_s, obs_s, degree=3, kappa=0.0, dof=4.0),
    }
    torch.cuda.synchronize()
    for name in smc.LAUNCHES:
        smc.LAUNCHES[name] = 0
    algs, build_s = {}, {}
    for name, make in makers.items():
        t0 = time.perf_counter()
        algs[name] = make()
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
    kxy_builds = smc.LAUNCHES["kxy"]
    results = {}
    for name, alg in algs.items():
        res = alg.forward_pass_batch(ys)
        results[name] = (res, stt.studentian_smoother(res))
    # the fused expectations and their gradients on the TPQSF dynamics kernel
    model = algs["TPQSF"].tf_dyn.model
    par_k = model.kernel.par.clone().requires_grad_(True)
    q, R, Qm = model.kernel.exp_x_qRQ(par_k, model.points)
    (g_qrq,) = torch.autograd.grad(q.sum() + R.sum() + Qm.sum(), par_k)
    (g_kxy,) = torch.autograd.grad(model.kernel.exp_xy_kxy(par_k), par_k)
    torch.cuda.synchronize()
    counts = dict(smc.LAUNCHES)
    log(f"Student path launches: {counts} (kxy {kxy_builds} while the transforms were built)")
    if kxy_builds < 4:
        fail(f"the kxy kernel ran {kxy_builds} times while the 4 BQ transforms were built")
    for name in ("qrq", "qrq_bwd", "kxy_bwd"):
        if counts[name] < 1:
            fail(f"the {name} kernel was not launched on the Student path")
    if not (bool(torch.isfinite(g_qrq).all()) and bool(torch.isfinite(g_kxy).all())):
        fail("the fused expectations' gradients are not finite")
    inc = {}
    for name, (res, (sm, sS)) in results.items():
        if tuple(res.fi_mean.shape) != tuple(xs.shape) or tuple(sS.shape) != (MC, 4, 4, CV_STEPS):
            fail(f"{name}: shapes {tuple(res.fi_mean.shape)}, {tuple(sS.shape)}")
        rmse_r, inc_r, nll_r = study_scores(torch, xs, res.fi_mean, res.fi_cov)
        ok = torch.isfinite(rmse_r) & torch.isfinite(inc_r) & torch.isfinite(nll_r)
        bad = 1.0 - float(ok.double().mean())
        inc[name] = float(inc_r[ok].mean())
        # the scale-matrix RTS pass of the JAX package grows without bound on
        # Monte-Carlo BQ cross-weights (PERF.md, open questions): reported only
        r_sm = torch.sqrt(torch.mean(torch.sum((sm - xs) ** 2, 1), -1))[ok]
        blown = float((r_sm > 10.0 * rmse_r[ok]).double().mean())
        log(f"CV glint {name} ({MC}x{CV_STEPS}): RMSE {float(rmse_r[ok].mean()):.4f}, "
            f"INC {inc[name]:.4f}, NLL {float(nll_r[ok].mean()):.4f}, diverged {bad:.4%}, "
            f"smoother RMSE median {float(r_sm.median()):.4g} ({blown:.2%} of runs above 10x "
            f"their filter RMSE), weights built in {build_s[name]:.2f} s")
        if bad > 0.01:
            fail(f"{name}: {bad:.2%} of the trajectories are not finite (limit 1%)")
    for name in ("TPQSF", "GPQSF"):
        if not inc[name] < inc["FSQ"]:
            fail(f"INC of {name} ({inc[name]:.3f}) is not below FSQ's ({inc['FSQ']:.3f})")
    for name, alg in algs.items():
        res = results[name][0]
        f_ms = cuda_ms(torch, lambda: alg.forward_pass_batch(ys), reps=3)
        s_ms = cuda_ms(torch, lambda: stt.studentian_smoother(res), reps=3)
        log(f"{name}: filter {f_ms[0]:.1f} ms (min {f_ms[1]:.1f}), smoother {s_ms[0]:.1f} ms "
            f"(min {s_ms[1]:.1f})")

    replaces = {"qrq": 73, "qrq_bwd": 199, "kxy": 325, "kxy_bwd": 406}
    return [{"name": f"student_{name}", "route": "cuda",
             "source": "ssmtoybox_torch/csrc/student_mc.cu",
             "replaces": f"ssmtoybox_tpu/ops/pallas_ops.py:{line}", "launches": counts[name],
             "max_abs_err": err[name], "ms": ms[name][0], "plain_ms": ms[name][1]}
            for name, line in replaces.items()]


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script runs the "
              "port on a CUDA card only", file=sys.stderr)
        return 1
    if not os.path.exists(os.path.join(HERE, "ssmtoybox_torch", "__init__.py")):
        print("chip_smoke: ssmtoybox_torch/ not found beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)

    import ssmtoybox_torch as stt
    from ssmtoybox_torch.ops import _build, scalar_filter as sf, student_mc as smc
    from ssmtoybox_torch.ssmod import (Radar2DMeasurement, ReentryVehicle2DTransition,
                                       UNGMMeasurement, UNGMTransition)
    from ssmtoybox_torch.utils import GaussRV
    from ssmtoybox_torch.utils.metrics import rmse

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"card: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for build in [pool.submit(sf.build), pool.submit(smc.build)]:
            build.result()
    log(f"built scalar_filter.cu and student_mc.cu for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("scalar_filter", "student_mc"):
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # ---- the study's models and data, simulated on the card ---------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dyn = UNGMTransition(GaussRV(1, cov=5.0, device=dev), GaussRV(1, cov=10.0, device=dev))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=1)
    x = dyn.simulate_discrete(gen, steps=UNGM_STEPS, mc_sims=MC)
    y = obs.simulate_measurements(gen, x)
    xs, ys = x.permute(2, 0, 1), y.permute(2, 0, 1)                # (M, D, N)
    ukf = stt.UnscentedKalman(dyn, obs)
    gpq = stt.GaussianProcessKalman(dyn, obs, np.array([[1.0, 3.0]]), np.array([[1.0, 3.0]]),
                                    points="ut")
    dyn_re = ReentryVehicle2DTransition(
        GaussRV(5, mean=np.array([6500.4, 349.14, -1.8093, -6.7967, 0.6932]),
                cov=np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0]), device=dev),
        GaussRV(3, cov=np.diag([2.4064e-5, 2.4064e-5, 1e-6]), device=dev), dt=0.05)
    obs_re = Radar2DMeasurement(GaussRV(2, cov=np.diag([1e-3, 1e-5]), device=dev),
                                dim_state=5, state_index=[0, 1],
                                radar_loc=np.array([6374.0, 0.0]))
    x_re = dyn_re.simulate_discrete(gen, steps=REENTRY_STEPS, mc_sims=MC)
    y_re = obs_re.simulate_measurements(gen, x_re)
    xs_re, ys_re = x_re.permute(2, 0, 1), y_re.permute(2, 0, 1)
    ukf_re = stt.UnscentedKalman(dyn_re, obs_re)
    lanes = {"ungm_ukf": (ukf, xs, ys, "dd"), "ungm_gpqkf": (gpq, xs, ys, "dd"),
             "reentry_ukf": (ukf_re, xs_re, ys_re, "f64")}
    torch.cuda.synchronize()

    # ---- 2. kernel vs plain twin, both on the card --------------------------
    y_tm = ys[:, 0, :].T.contiguous()                                # (N, M)
    c = torch.as_tensor(sf.ungm_consts(UNGM_STEPS), device=dev)
    names = ("m_fi", "P_fi", "m_pr", "P_pr", "xx")
    max_err = 0.0
    for rule, alg in (("ukf", ukf), ("gpq", gpq)):
        params = sf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
        for n_steps, tol in ((1, 1e-13), (20, 1e-9)):
            yy = y_tm[:n_steps, :COMPARE_B].contiguous()
            got = sf.scalar_filter(params, yy, c[:n_steps].contiguous())
            ref = sf._scalar_filter_plain(params, yy, c[:n_steps].contiguous())
            torch.cuda.synchronize()
            errs = [float((g_ - r_).abs().max()) for g_, r_ in zip(got, ref)]
            if n_steps == 20:
                max_err = max(max_err, *errs)
            for name, g_, r_, err in zip(names, got, ref, errs):
                if not torch.allclose(g_, r_, atol=tol, rtol=tol):
                    fail(f"{rule} kernel vs twin, N={n_steps}, {name}: max |diff| {err:.3e} "
                         f"exceeds atol=rtol={tol}")
            log(f"kernel == twin ({rule}, N={n_steps}, B={COMPARE_B}, tol {tol}): max |diff| "
                + ", ".join(f"{n} {e:.2e}" for n, e in zip(names, errs)))
        got = sf.scalar_filter(params, y_tm, c)[0]
        ref = sf._scalar_filter_plain(params, y_tm, c)[0]
        x_tm = xs[:, 0].T[None]                                      # (1, N, M)
        r_got, r_ref = float(rmse(x_tm, got[None])), float(rmse(x_tm, ref[None]))
        rel = abs(r_got - r_ref) / r_ref
        log(f"kernel vs twin study RMSE ({rule}, B={MC}, N={UNGM_STEPS}): {r_got:.6f} vs "
            f"{r_ref:.6f}, relative {rel:.2e} (limit 1e-3)")
        if not rel < 1e-3:
            fail(f"{rule} study RMSE of kernel and twin differ by {rel:.3e} relative")

    # ---- 3. goldens on the card ------------------------------------------
    g = np.load(os.path.join(HERE, "tests", "goldens", "ungm.npz"))
    dyn_g = UNGMTransition(GaussRV(1, cov=1.0, device=dev), GaussRV(1, cov=10.0, device=dev))
    obs_g = UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=1)
    batch_g = torch.as_tensor(np.moveaxis(g["y"], -1, 0), device=dev)
    for name, alg in (("ukf", stt.UnscentedKalman(dyn_g, obs_g)),
                      ("gpqkf", stt.GaussianProcessKalman(dyn_g, obs_g, np.array([[1.0, 3.0]]),
                                                          np.array([[1.0, 3.0]])))):
        for engine in ("dd", "f64"):
            res = alg.forward_pass_batch(batch_g, engine=engine)
            sm, _ = stt.gaussian_smoother(res)
            for got, key in ((res.fi_mean[0], "fm"), (res.fi_cov[0], "fP"), (sm[0], "sm")):
                if not np.allclose(got.cpu().numpy(), g[f"{name}_{key}"], atol=1e-8, rtol=1e-8):
                    fail(f"golden ungm {name}_{key} ({engine}) off by "
                         f"{np.abs(got.cpu().numpy() - g[f'{name}_{key}']).max():.3e}")
    g = np.load(os.path.join(HERE, "tests", "goldens", "reentry.npz"))
    fm, fP = ukf_re.forward_pass(torch.as_tensor(g["y"][..., 0], device=dev))
    for got, key in ((fm, "ukf_fm"), (fP, "ukf_fP")):
        if not np.allclose(got.cpu().numpy(), g[key], atol=1e-7, rtol=1e-6):
            fail(f"golden reentry {key} off by {np.abs(got.cpu().numpy() - g[key]).max():.3e}")
    ukf_re.reset()
    log("goldens on the card: ungm UKF/GPQKF (dd and f64, 1e-8), reentry UKF (1e-7/1e-6) ok")

    # ---- 4. the main path -------------------------------------------------
    sf.LAUNCHES = 0
    results = {}
    for lane, (alg, x_true, data, engine) in lanes.items():
        res = alg.forward_pass_batch(data, engine=engine)
        sm_m, sm_P = stt.gaussian_smoother(res)
        results[lane] = (res, sm_m, sm_P, x_true)
    torch.cuda.synchronize()
    launches = sf.LAUNCHES
    if launches < 2:
        fail(f"the UNGM lanes launched the scalar filter kernel {launches} times; expected 2")
    for lane, (res, sm_m, sm_P, x_true) in results.items():
        M, D, N = x_true.shape
        if tuple(res.fi_mean.shape) != (M, D, N) or tuple(sm_P.shape) != (M, D, D, N):
            fail(f"{lane}: shapes {tuple(res.fi_mean.shape)}, {tuple(sm_P.shape)}")
        for name, t in (("fi_mean", res.fi_mean), ("fi_cov", res.fi_cov), ("sm_mean", sm_m),
                        ("sm_cov", sm_P)):
            if not bool(torch.isfinite(t).all()):
                fail(f"{lane}: {name} is not finite")
        r_fi = float(rmse(x_true.permute(1, 2, 0), res.fi_mean.permute(1, 2, 0)))
        r_sm = float(rmse(x_true.permute(1, 2, 0), sm_m.permute(1, 2, 0)))
        if not r_sm < r_fi:
            fail(f"{lane}: smoother RMSE {r_sm} not below filter RMSE {r_fi}")
        log(f"{lane} ({lanes[lane][3]}, {M}x{N}): RMSE filter {r_fi:.6f}, smoother {r_sm:.6f}")
    log(f"main path: scalar filter kernel launches {launches}")

    # ---- 5. timings (after the counts were read) --------------------------
    params = sf.prepare(dyn, obs, ukf.tf_dyn, ukf.tf_obs)
    k_ms, k_min = cuda_ms(torch, lambda: sf.scalar_filter(params, y_tm, c))
    p_ms, p_min = cuda_ms(torch, lambda: sf._scalar_filter_plain(params, y_tm, c), reps=3)
    log(f"scalar_filter UKF rule {MC}x{UNGM_STEPS}: kernel {k_ms:.3f} ms (min {k_min:.3f}), "
        f"plain twin {p_ms:.1f} ms (min {p_min:.1f})")
    for lane, (alg, _, data, engine) in lanes.items():
        t = {engine: cuda_ms(torch, lambda: alg.forward_pass_batch(data, engine=engine), reps=3)}
        if engine == "dd":
            t["f64"] = cuda_ms(torch, lambda: alg.forward_pass_batch(data, engine="f64"), reps=3)
        res = results[lane][0]
        t["smoother"] = cuda_ms(torch, lambda: stt.gaussian_smoother(res), reps=3)
        log(f"{lane}: " + ", ".join(f"{k} {v[0]:.2f} ms (min {v[1]:.2f})" for k, v in t.items()))

    student = student_slice(torch, np, dev)

    kernels = {"kernels": [{
        "name": "scalar_filter", "route": "cuda", "source": "ssmtoybox_torch/csrc/scalar_filter.cu",
        "replaces": "ssmtoybox_tpu/ops/ddscan_pallas.py:37", "launches": launches,
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}] + student}
    print(json.dumps(kernels), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
