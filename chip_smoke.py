#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ssmtoybox_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (PATH, $CUDA_HOME or /usr/local/cuda); it
fails at once without them.  Phases, each fatal on failure:

1. set-up: print the card's name and power limit, build the CUDA kernel
   ``ssmtoybox_torch/csrc/scalar_filter.cu`` for sm_90a;
2. kernel vs its plain PyTorch twin, both on the card, for the UKF and the
   GPQ rule: one step at B=4096 (pointwise 1e-13), 20 steps at B=4096
   (pointwise 1e-9), and study RMSE at B=10,000 x 500 steps (relative 1e-3;
   the UNGM map decorrelates single trajectories over 500 steps);
3. the port against the repo's golden references (tests/goldens) on the card;
4. the main path at the study sizes: 10,000 trajectories in float64, UNGM
   UKF and GPQKF through the kernel (``engine="dd"``), reentry UKF through
   the eager batched path, then the RTS smoother and RMSE of every lane;
5. timings with CUDA events after a warm-up.

The line before the last two is a JSON object describing each kernel; the
line before the last is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

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
    from ssmtoybox_torch.ops import _build, scalar_filter as sf
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
    sf.build()
    log(f"built scalar_filter.cu for sm_90a in {time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOGS.get("scalar_filter", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

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

    kernels = {"kernels": [{
        "name": "scalar_filter", "route": "cuda", "source": "ssmtoybox_torch/csrc/scalar_filter.cu",
        "replaces": "ssmtoybox_tpu/ops/ddscan_pallas.py:37", "launches": launches,
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}]}
    print(json.dumps(kernels), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
