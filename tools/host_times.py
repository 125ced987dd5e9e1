#!/usr/bin/env python3
"""Times of the calls around the two small kernels (the scalar filter and the
Vandermonde matrix) as a study makes them, on one CUDA card.

    python3 tools/host_times.py [--repo DIR] [--tag NAME]

``--repo`` names the checkout whose ``ssmtoybox_torch`` is timed (default: the
one this file lies in), so two commits can be compared in one run on one
card: unpack the other commit somewhere and run this file once for each,
in turns.  Only entry points that both have are called.  Printed, each
line starting with ``--tag``:

- a ``vandermonde`` wrapper call at the Monte-Carlo verifiers' shape (5 x
  100,000 points, Q = 11): CUDA events around one call, median of 5, and the
  host clock over 200 calls without synchronising; and the kernel's own
  time there and at two weight shapes (1 x 7 with Q = 7, 5 x 11 with Q = 11)
  as ``torch.profiler`` records it (mean over the records kept of 10 calls);
- the 21 Vandermonde calls of the two verifiers (``mc_exp_x_kxpx``,
  ``mc_exp_x_cov``, 10 x 100,000 samples) with everything around them;
- both transforms of a BSQ filter built: the UNGM study's UT, GH-5 and GH-7
  rules, and the 5-D pair of the reentry tracking study;
- a ``scalar_filter`` wrapper call and a whole UNGM lane
  (``forward_pass_batch(engine="dd")``) at 10,000 x 500 for the UT, GH-7 and
  BSQ-GH7 rules.

Wall times end in ``torch.cuda.synchronize()``; medians of 5 (3 for builds
and verifiers) after one warm-up.
"""
import argparse
import os
import statistics
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", default="here")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import numpy as np
    import torch
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.bq.models import BayesSardModel
    from ssmtoybox_torch.ops import scalar_filter as sf, vandermonde as vdm
    from ssmtoybox_torch.ssmod import (Radar2DMeasurement, ReentryVehicle2DTransition,
                                       UNGMMeasurement, UNGMTransition)
    from ssmtoybox_torch.utils import GaussRV
    if not torch.cuda.is_available():
        print("host_times: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    say = lambda text: print(f"{args.tag}: {text}", flush=True)  # noqa: E731
    say(f"{os.path.dirname(stt.__file__)} on " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())

    def event_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times), min(times)

    def wall_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), min(times)

    def host_us(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / reps * 1e6

    mul_ut5 = np.hstack((np.zeros((5, 1), int), np.eye(5, dtype=int), 2 * np.eye(5, dtype=int)))
    x = torch.randn((5, 100_000), dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    med, low = event_ms(lambda: vdm.vandermonde(mul_ut5, x))
    say(f"vandermonde wrapper call, 5 x 100,000, Q = 11: {med:.4f} ms (min {low:.4f}), host "
        f"{host_us(lambda: vdm.vandermonde(mul_ut5, x)):.1f} us a call")

    def device_ms(fn):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        found = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "vandermonde_kernel" in e.name]
        return f"{sum(found) / len(found) / 1e3:.4f} ms ({len(found)} records)" if found else "none"

    x11 = x[:, :11].contiguous()
    x7 = torch.linspace(-2.0, 2.0, 7, dtype=torch.float64, device=dev)[None]
    mul7 = np.atleast_2d(np.arange(7))
    say("vandermonde kernel on the device: 5 x 100,000, Q = 11 "
        + device_ms(lambda: vdm.vandermonde(mul_ut5, x)) + "; 5 x 11, Q = 11 "
        + device_ms(lambda: vdm.vandermonde(mul_ut5, x11)) + "; 1 x 7, Q = 7 "
        + device_ms(lambda: vdm.vandermonde(mul7, x7)))

    par5 = np.array([[1.0, 1, 1, 1, 1, 1]])
    model = BayesSardModel(5, par5, mul_ut5, "ut", compat_kxpx_ell_squared=False, device=dev)

    def verifiers():
        gen = torch.Generator(device=dev).manual_seed(0)
        model.mc_exp_x_kxpx(gen)
        model.mc_exp_x_cov(gen)

    before = vdm.LAUNCHES
    med, low = wall_ms(verifiers)
    say(f"the two Monte-Carlo verifiers ({(vdm.LAUNCHES - before) // 4} Vandermonde launches): "
        f"{med:.2f} ms (min {low:.2f})")

    dyn = UNGMTransition(GaussRV(1, cov=5.0), GaussRV(1, cov=10.0))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1)

    def bsq(par, mi, **kw):
        return stt.BayesSardKalman(dyn, obs, np.array(par), np.array(par), mulind_dyn=mi,
                                   mulind_obs=mi, **kw)

    gh = lambda deg: dict(points="gh", point_hyp={"degree": deg})  # noqa: E731
    builds = {"BSQ-UT": lambda: bsq([[3.0, 0.3]], np.array([[0, 1, 2]]), points="ut"),
              "BSQ-GH5": lambda: bsq([[5.0, 0.6]], np.atleast_2d(np.arange(5)), **gh(5)),
              "BSQ-GH7": lambda: bsq([[3.0, 0.4]], np.atleast_2d(np.arange(7)), **gh(7))}
    dyn_t = ReentryVehicle2DTransition(
        GaussRV(5, mean=[6500.0, 350.0, -1.1, -6.1, 0.7],
                cov=np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0])),
        GaussRV(3, cov=np.diag([2.4e-5, 2.4e-5, 1e-6])), dt=0.1)
    obs_t = Radar2DMeasurement(GaussRV(2, cov=np.diag([1e-6, 0.17e-6])), dim_state=5,
                               radar_loc=np.array([6374.0, 0.0]))
    builds["tracking 5-D"] = lambda: stt.BayesSardKalman(
        dyn_t, obs_t, par5, np.array([[1.0, 0.9, 0.9, 1e4, 1e4, 1e4]]), mulind_dyn=mul_ut5,
        mulind_obs=mul_ut5, points="ut")
    for name, make in builds.items():
        med, low = wall_ms(make)
        say(f"{name}: both BSQ transforms built in {med:.2f} ms (min {low:.2f})")

    gen = torch.Generator(device=dev).manual_seed(0)
    xs = dyn.simulate_discrete(gen, steps=500, mc_sims=10_000)
    ys = obs.simulate_measurements(gen, xs).permute(2, 0, 1)
    y_tm = ys[:, 0, :].T.contiguous()
    c = torch.as_tensor(sf.ungm_consts(500), device=dev)
    lanes = {"UT": stt.UnscentedKalman(dyn, obs, alpha=1.0, beta=0.0),
             "GH-7": stt.GaussHermiteKalman(dyn, obs, deg=7), "BSQ-GH7": builds["BSQ-GH7"]()}
    for name, alg in lanes.items():
        params = sf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
        k_med, k_low = event_ms(lambda: sf.scalar_filter(params, y_tm, c))
        l_med, l_low = event_ms(lambda: alg.forward_pass_batch(ys, engine="dd"))
        say(f"UNGM {name} 10,000 x 500: scalar_filter wrapper call {k_med:.4f} ms (min "
            f"{k_low:.4f}), lane forward_pass_batch(engine='dd') {l_med:.4f} ms (min {l_low:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
