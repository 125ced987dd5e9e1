"""The slot design of the scalar filter kernel's general and registered forms
(``sfs_record`` in ``csrc/scalar_filter_step_general.cuh``, launched by
``csrc/scalar_filter_slots.cuh``): the shaped form's step at 3-16
compile-time slots on lanes (17-32 points: ``test_torch_sf_wide_slots.py``),
the models as a policy's functors, both rules staged as the kernel stages
them in shared memory, no scratch.

- Host builds: ``csrc/scalar_filter_host.cpp`` built with g++ (one lane a
  trajectory) equals the plain version ``_scalar_filter_plain`` to the bit,
  all five streams, with the C library's square root and sine, on 30-step
  records of 1 and 7 trajectories: GH-9, GH-12 and GH-15 (9, 12 and 16
  slots), GH-16, GH-17 (20 slots, since the slot design reaches 32
  points), GPQ on GH-9 and GH-15, BSQ on GH-9, a 15-point dynamics rule
  beside a 9-point measurement rule, the range and sine measurements under
  the UKF and GH-15, a registered transition under the UKF and GH-9 and a
  registered measurement (the registered form's generated library, built
  once for the module).
- Routing: :func:`scalar_filter.geometry` (the step header's
  ``sf_design_of``, asked through the host build) names each case's design,
  slot count and lanes; :func:`scalar_filter.slots` agrees with the
  header's slot count for every pair of kinds and point counts up to 20.
- Against the JAX package's double-double dd filter
  (``ssmtoybox_tpu.ops.ddfilter.scalar_filter_batch``, ``lax.scan`` engine)
  on the CPU: UNGM under GH-12 and under BSQ on GH-9, the filtered means at
  ``tests/test_torch_dd_pairs.py``'s tolerances (1e-10 classical, 1e-8 BQ)
  over the first 10 steps and at 1e-8 over all 20 (the Pallas kernel's
  tolerance in ``tests/test_torch_scalar_filter.py``): float64 and
  double-double round apart by ~1e-16 a step and the UNGM map grows that,
  to 3.3e-10 by step 20 on one of these records under GH-12.
- GPQ on 9, 15 and 16 Gauss-Hermite points: both packages' weights against
  the same weights in 60-digit arithmetic, and UNGM under GPQ on GH-9
  against the JAX package's dd filter, with the measured gap: the
  reference's weights are further from the exact ones than the port's
  (run the module as a script for the readings).

Records are simulated with a numpy seed through the port's model functions.
"""
import ctypes
import math
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu.ops.ddfilter import scalar_filter_batch as jax_scalar_filter_batch
from ssmtoybox_tpu.ssmod import UNGMMeasurement as JUNGMMeasurement
from ssmtoybox_tpu.ssmod import UNGMTransition as JUNGMTransition
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import set_device, ssmod
from ssmtoybox_torch.ops import KernelForm, forms, register_dyn_dd, register_obs_dd
from ssmtoybox_torch.ops import scalar_filter as sf
from ssmtoybox_torch.utils import GaussRV


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port runs on the card unless told otherwise; these tests run it
    on the CPU, on one intra-op thread (the suite runs several workers at
    once)."""
    set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    set_device(None)


def _libm(fn):
    def apply(*ts):
        flat = [t.reshape(-1).tolist() for t in ts]
        out = torch.tensor([fn(*v) for v in zip(*flat)], dtype=torch.float64)
        return out.reshape(ts[0].shape)
    return apply


#: the C library's transcendentals, one value at a time: what the g++ build
#: calls (PyTorch's vectorised CPU versions may be an ulp off)
LIBM_FNS = SimpleNamespace(
    sqrt=_libm(lambda v: math.sqrt(v) if v >= 0.0 or v != v else math.nan),
    exp=_libm(lambda v: math.exp(v) if v < 709.0 or v != v else math.inf),
    sin=_libm(math.sin), cos=_libm(math.cos), atan2=_libm(math.atan2))

T = 30
KPAR = np.array([[1.0, 3.0]])


class Growth(ssmod.TransitionModel):
    """``0.5 x + 5 x / (1 + x^2) + 2 cos(0.7 t)``, registered below."""
    dim_state, dim_noise = 1, 1

    def dyn_fcn(self, x, q, time):
        return 0.5 * x + 5.0 * (x / (1.0 + x * x)) + 2.0 * math.cos(0.7 * time) + q


class Sat(ssmod.MeasurementModel):
    """``x + 0.5 sin(x)``, registered below."""
    dim_substate, dim_out, dim_noise = 1, 1, 1

    def meas_fcn(self, x, r, time):
        return 1.0 * x + 0.5 * torch.sin(x) + r


@pytest.fixture(scope="module", autouse=True)
def _registered():
    """``Growth`` and ``Sat`` in the port's scalar registry for the module."""
    register_dyn_dd(Growth, lambda m, n: 2.0 * np.cos(0.7 * np.arange(n)), KernelForm(
        "f[0] = 0.5 * x[0] + 5.0 * (x[0] / (1.0 + x[0] * x[0])) + s[0];", (),
        lambda x, c, s, fns: 0.5 * x + 5.0 * (x / (1.0 + x * x)) + s[0]))
    register_obs_dd(Sat, KernelForm("h[0] = c[0] * x[0] + c[1] * sin(x[0]);", (1.0, 0.5),
                                    lambda x, c, fns: c[0] * x + c[1] * fns.sin(x)))
    yield
    forms.DYN_DD.pop(Growth, None)
    forms.OBS_DD.pop(Sat, None)


def _system(dyn, obs):
    d = (Growth(GaussRV(1, cov=1.0), GaussRV(1, cov=1.0)) if dyn == "growth" else
         ssmod.UNGMTransition(GaussRV(1, cov=5.0), GaussRV(1, cov=10.0)))
    o = {"ungm": lambda: ssmod.UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1),
         "range": lambda: ssmod.RangeMeasurement(GaussRV(1, cov=0.03), dim_state=1),
         "sine": lambda: ssmod.Pendulum2DMeasurement(GaussRV(1, cov=0.1), dim_state=1),
         "sat": lambda: Sat(GaussRV(1, cov=0.1), dim_state=1)}[obs]()
    return d, o


def _rule(d, o, rule):
    """The filter of ``rule`` (``a/b``: rule a on the dynamics, b on the
    measurement)."""
    if "/" in rule:
        a, b = (_rule(d, o, r) for r in rule.split("/"))
        return SimpleNamespace(mod_dyn=d, mod_obs=o, tf_dyn=a.tf_dyn, tf_obs=b.tf_obs)
    if rule == "ukf":
        return stt.UnscentedKalman(d, o)
    if rule.startswith("gh"):
        return stt.GaussHermiteKalman(d, o, deg=int(rule[2:]))
    deg = int(rule.rpartition("gh")[2])
    if rule.startswith("gpq"):
        return stt.GaussianProcessKalman(d, o, KPAR, KPAR, points="gh", point_hyp={"degree": deg})
    mi = np.atleast_2d(np.arange(deg))
    return stt.BayesSardKalman(d, o, KPAR, KPAR, mulind_dyn=mi, mulind_obs=mi, points="gh",
                               point_hyp={"degree": deg})


#: (transition, measurement, rule) -> (design, slots, lanes) the launcher
#: gives it
CASES = {
    ("ungm", "ungm", "gh9"): ("slots", 9, 2),
    ("ungm", "ungm", "gh12"): ("slots", 12, 2),
    ("ungm", "ungm", "gh15"): ("slots", 16, 2),
    ("ungm", "ungm", "gh16"): ("slots", 16, 2),
    ("ungm", "ungm", "gh17"): ("slots", 20, 2),
    ("ungm", "ungm", "gpq_gh9"): ("slots", 9, 2),
    ("ungm", "ungm", "gpq_gh15"): ("slots", 16, 4),
    ("ungm", "ungm", "bsq_gh9"): ("slots", 9, 2),
    ("ungm", "ungm", "gh15/gh9"): ("slots", 16, 2),
    ("ungm", "range", "ukf"): ("slots", 3, 4),
    ("ungm", "range", "gh15"): ("slots", 16, 2),
    ("ungm", "sine", "ukf"): ("slots", 3, 4),
    ("ungm", "sine", "gh15"): ("slots", 16, 2),
    ("growth", "ungm", "ukf"): ("slots", 3, 4),
    ("growth", "ungm", "gh9"): ("slots", 9, 2),
    ("ungm", "sat", "ukf"): ("slots", 3, 4),
}
IDS = ["-".join(c).replace("/", "+") for c in CASES]


def _params(case):
    d, o = _system(*case[:2])
    alg = _rule(d, o, case[2])
    return sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)


def _records(case, batch, seed=5):
    """(T, batch) time-major measurements simulated with numpy noise through
    the port's model functions."""
    d, o = _system(*case[:2])
    rng = np.random.default_rng(seed)
    m0, P0 = (float(t) for t in d.init_rv.get_stats()[:2])
    q, r = float(d.noise_rv.get_stats()[1]), float(o.noise_rv.get_stats()[1])
    x = torch.as_tensor(rng.normal(m0, math.sqrt(P0), (batch, 1)))
    ys = []
    for k in range(T):
        x = d.dyn_fcn(x, torch.as_tensor(rng.normal(0.0, math.sqrt(q), (batch, 1))), k)
        ys.append(o.meas_fcn(x, torch.as_tensor(rng.normal(0.0, math.sqrt(r), (batch, 1))),
                             k + 1)[:, 0])
    return torch.stack(ys)


@pytest.fixture(scope="module")
def host_built():
    """One g++ build of the registered form's generated source for the
    module's registered cases (the kernel's own models' host build is
    ``csrc/scalar_filter_host.cpp`` as it stands, built at first use)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the step header cannot be built for the host")
    registered = [p for p in map(_params, CASES) if sf.form_of(p) == "registered"]
    return sf.build_registered(registered, host=True)


@pytest.mark.parametrize("batch", [1, 7])
@pytest.mark.parametrize("case", list(CASES), ids=IDS)
def test_slot_design_on_host_matches_plain(host_built, case, batch):
    """The host build of the case's design == the plain version to the bit,
    all five streams; measurements read through their strides (time-major
    and the transpose of a trajectory-major batch)."""
    params = _params(case)
    y = _records(case, batch)
    c = sf.step_consts(params, T, "cpu")
    want = sf._scalar_filter_plain(params, y, c, sqrt=LIBM_FNS.sqrt, sin=LIBM_FNS.sin,
                                   fns=LIBM_FNS)
    for yy in (y, y.T.contiguous().T):
        for a, b in zip(sf._host_shim_run(params, yy, c), want):
            assert bool(torch.isfinite(b).all())
            assert torch.equal(a, b), f"max |diff| {float((a - b).abs().max()):.3e}"


@pytest.mark.parametrize("case", list(CASES), ids=IDS)
def test_geometry_routes_each_case(host_built, case):
    """The form, design, slot count and lanes of each case, as the step
    header's ``sf_design_of`` gives them through the host build: the general
    or registered form, in the slot design up to 16 points (padded to 9, 12
    or 16 slots above 8; 17 points at 20 slots); classical rules on 4 lanes
    up to 8 slots and on 2 above, a BQ rule on 2 lanes up to 9 slots and on
    4 above."""
    params = _params(case)
    assert sf.form_of(params) == ("registered" if "growth" in case or "sat" in case
                                  else "general")
    assert sf.geometry(params) == CASES[case]
    n = max(params.dyn.n, params.obs.n)
    assert sf._scratch(params, 7, "cpu").numel() == (0 if CASES[case][1] else n * 7)


def test_slots_agrees_with_the_header(host_built):
    """:func:`scalar_filter.slots`, which keys the registered libraries and
    sizes the one-thread design's scratch, gives the slot count of the
    header's ``sf_slots`` (through ``sf_design``) for both kinds of either
    rule and 1-20 points; the shaped form's UNGM rules take their own
    lanes."""
    lib = sf._host_shim()
    got_slots, got_lanes = ctypes.c_int(), ctypes.c_int()
    for kd in (0, 1):
        for ko in (0, 1):
            for n_dyn in range(1, 21):
                for n_obs in (1, 3, n_dyn):
                    lib.sf_design(0, kd, ko, n_dyn, n_obs, ctypes.byref(got_slots),
                                  ctypes.byref(got_lanes))
                    p = SimpleNamespace(dyn=SimpleNamespace(kind=kd, n=n_dyn),
                                        obs=SimpleNamespace(kind=ko, n=n_obs))
                    assert got_slots.value == sf.slots(p), (kd, ko, n_dyn, n_obs)
                    assert got_lanes.value in ((1, 2, 4, 8) if got_slots.value else (1,))
    shaped = _params(("ungm", "ungm", "ukf"))
    assert sf.geometry(shaped) == ("shaped", 3, 2)


@pytest.mark.parametrize("rule", ["gh12", "bsq_gh9"])
def test_slot_design_matches_jax_dd_filter(rule):
    """The port's ``engine="dd"`` (on the CPU, the plain version of the slot
    design's kernel) against the JAX package's double-double dd filter on
    the same 20-step records of 4 trajectories: filtered means at 1e-10
    (classical) and 1e-8 (BQ) over the first 10 steps, at 1e-8 over all
    20."""
    case = ("ungm", "ungm", rule)
    params = _params(case)
    assert sf.geometry(params)[0] == "slots"
    ys = _records(case, 4)[:20].T.contiguous()                        # (B, N)
    jd = JUNGMTransition.create(JGaussRV.create(1, cov=5.0), JGaussRV.create(1, cov=10.0))
    jo = JUNGMMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1)
    deg = int(rule.rpartition("gh")[2])
    mi = np.atleast_2d(np.arange(deg))
    jalg = (st.GaussHermiteKalman(jd, jo, deg=deg) if rule.startswith("gh") else
            st.BayesSardKalman(jd, jo, KPAR, KPAR, mulind_dyn=mi, mulind_obs=mi, points="gh",
                               point_hyp={"degree": deg}))
    want = np.asarray(jax_scalar_filter_batch(jd, jo, jalg.tf_dyn, jalg.tf_obs,
                                              jnp.asarray(ys.numpy()), engine="scan"))
    d, o = _system(*case[:2])
    alg = _rule(d, o, rule)
    got = alg.forward_pass_batch(ys[:, None, :], engine="dd").fi_mean
    tol = 1e-8 if rule.startswith("bsq") else 1e-10
    np.testing.assert_allclose(got.numpy()[..., :10], want[..., :10], atol=tol, rtol=tol)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=1e-8)


def test_slot_rules_struct_matches_the_header():
    """The ctypes mirror of ``SfsVec`` / ``SfsRules`` has the header's fields
    and size; a rule's vectors are zero past its points, and all zero for
    rules the slot design does not take."""
    src = open(sf._build.CSRC + "/scalar_filter_step_general.cuh").read()
    body = src.split("struct SfsVec {")[1].split("};")[0]
    for name, _ in sf._CVec._fields_:
        assert f" {name}[SF_MAX_SLOTS];" in body, name
    assert ctypes.sizeof(sf._CSlotRules) == 2048 and "sizeof(SfsRules) == 2048" in src
    assert f"#define SF_MAX_SLOTS {sf.MAX_SLOTS}" in open(sf._build.CSRC
                                                          + "/scalar_filter_step.cuh").read()
    params = _params(("ungm", "ungm", "gpq_gh9"))
    c = sf._c_slot_rules(params)
    assert list(c.dyn.xi) == list(params.dyn.xi) + [0.0] * (sf.MAX_SLOTS - 9)
    assert list(c.obs.wcc) == list(params.obs.wcc) + [0.0] * (sf.MAX_SLOTS - 9)
    assert not any(c.dyn.wc)
    assert not any(sf._c_slot_rules(_params(("ungm", "ungm", "gh33"))).dyn.xi)


# ---------------------------------------------------------------------------
# GPQ on 9 and more Gauss-Hermite points: the port's weights against the
# JAX package's and against the same weights in 60-digit arithmetic
# ---------------------------------------------------------------------------

#: the Gauss-Hermite point counts of the GPQ readings
GPQ_DEGREES = (9, 15, 16)


def _gpq_pair(deg):
    """The UNGM system under GPQ on GH-``deg`` points (``KPAR``) in the JAX
    package and in the port."""
    jd = JUNGMTransition.create(JGaussRV.create(1, cov=5.0), JGaussRV.create(1, cov=10.0))
    jo = JUNGMMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1)
    jalg = st.GaussianProcessKalman(jd, jo, KPAR, KPAR, points="gh", point_hyp={"degree": deg})
    alg = _rule(*_system("ungm", "ungm"), f"gpq_gh{deg}")
    return (jd, jo, jalg), alg


def _exact_weights(tf):
    """``(wm, Wc, wcc, emv)`` of a port GP transform computed in 60-digit
    arithmetic (mpmath) from the float64 Gram ``K`` (jittered, unscaled),
    ``q``, ``R`` and ``Q`` that both packages start from, rounded to
    float64: ``q K^-1``, ``K^-1 Q K^-1``, ``R K^-1``, ``E k(x, x) (1 - tr(Q
    K^-1))``."""
    import mpmath
    m = tf.model
    par = m.kernel.get_parameters(None)
    K = m.kernel._jittered(par, m.points, False).numpy()
    q, R, Q = (t.numpy() for t in m.kernel.exp_x_qRQ(par, m.points))
    with mpmath.workdps(60):
        iK, Qm = mpmath.matrix(K.tolist()) ** -1, mpmath.matrix(Q.tolist())
        QiK = Qm * iK
        got = (mpmath.matrix([q.tolist()]) * iK, iK * QiK, mpmath.matrix([R.ravel().tolist()]) * iK,
               float(m.kernel.exp_x_kxx(par)) * (1 - sum(QiK[i, i] for i in range(len(q)))))
        return (np.array(got[0].tolist(), dtype=float)[0], np.array(got[1].tolist(), dtype=float),
                np.array(got[2].tolist(), dtype=float)[0], float(got[3]))


def _jax_weights(tf):
    return (np.asarray(tf.wm), np.asarray(tf.Wc), np.asarray(tf.Wcc).ravel(),
            float(np.asarray(tf.model_var).ravel()[0]))


def _port_weights(rule):
    return np.array(rule.wm), np.array(rule.Wc), np.array(rule.wcc), rule.emv


def _with_weights(rule, weights):
    """``rule`` (a ``scalar_filter.Rule``) with the weights ``weights``."""
    import dataclasses
    wm, Wc, wcc, emv = weights
    return dataclasses.replace(rule, wm=tuple(map(float, wm)),
                               Wc=tuple(tuple(map(float, r)) for r in Wc),
                               wcc=tuple(map(float, wcc)), emv=float(emv))


def _centred(weights):
    """``1^T Wc 1 - (1^T wm)^2``: the variance the rule gives a constant
    integrand, which is 0 for the exact weights up to the jitter."""
    return float(np.sum(weights[1]) - np.sum(weights[0]) ** 2)


def gpq_weight_readings(deg):
    """The dynamics rule's weights under GPQ on GH-``deg`` points in the
    port and in the JAX package against the exact ones (:func:`_exact_weights`):
    the Gram's condition number, max |Wc - exact| and |emv - exact| of each
    package, and the centred sum (:func:`_centred`) of each and of the exact
    weights."""
    (_, _, jalg), alg = _gpq_pair(deg)
    params = sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    exact, port, jax_ = (_exact_weights(alg.tf_dyn), _port_weights(params.dyn),
                         _jax_weights(jalg.tf_dyn))
    m = alg.tf_dyn.model
    K = m.kernel._jittered(m.kernel.get_parameters(None), m.points, False).numpy()
    return {"cond": float(np.linalg.cond(K)), "max_wc": float(np.abs(exact[1]).max()),
            **{f"wc_{k}": float(np.abs(w[1] - exact[1]).max()) for k, w in
               (("port", port), ("jax", jax_))},
            **{f"emv_{k}": abs(w[3] - exact[3]) for k, w in (("port", port), ("jax", jax_))},
            **{f"centred_{k}": _centred(w) for k, w in
               (("exact", exact), ("port", port), ("jax", jax_))}}


def gpq_filter_readings(deg, batch=4, steps=20):
    """The filtered means of UNGM under GPQ on GH-``deg`` points on
    ``steps``-step records of ``batch`` trajectories: the JAX package's dd
    filter, the port's kernel step (its plain version on the CPU) with its
    own weights, with the JAX package's weights and with the exact ones.
    Returns each step's max |difference| over the runs finite in both: port
    against JAX (``own``), the port on JAX's weights against JAX (``same``),
    and the port's and JAX's filter against the port on the exact weights
    (``port_exact``, ``jax_exact``); and the finite share of each run."""
    (jd, jo, jalg), alg = _gpq_pair(deg)
    params = sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    y = _records(("ungm", "ungm", f"gpq_gh{deg}"), batch)[:steps].contiguous()
    c = sf.step_consts(params, steps, "cpu")

    def port(dyn, obs):
        import dataclasses
        return sf._scalar_filter_plain(dataclasses.replace(params, dyn=dyn, obs=obs), y,
                                       c)[0].numpy()
    own = port(params.dyn, params.obs)
    same = port(_with_weights(params.dyn, _jax_weights(jalg.tf_dyn)),
                _with_weights(params.obs, _jax_weights(jalg.tf_obs)))
    exact = port(_with_weights(params.dyn, _exact_weights(alg.tf_dyn)),
                 _with_weights(params.obs, _exact_weights(alg.tf_obs)))
    ref = np.asarray(jax_scalar_filter_batch(jd, jo, jalg.tf_dyn, jalg.tf_obs,
                                             jnp.asarray(y.T.numpy()), engine="scan"))[:, 0].T

    def gap(a, b):
        both = np.isfinite(a).all(0) & np.isfinite(b).all(0)
        return np.abs(a[:, both] - b[:, both]).max(1) if both.any() else np.full(steps, np.nan)
    return {"own": gap(own, ref), "same": gap(same, ref), "port_exact": gap(own, exact),
            "jax_exact": gap(ref, exact),
            **{f"finite_{k}": float(np.isfinite(v).all(0).mean())
               for k, v in (("port", own), ("jax", ref), ("exact", exact))}}


def gpq_proxy_readings(deg, meas, batch=1000):
    """UNGM with the ``meas`` measurement under GPQ on GH-``deg`` points,
    ``T``-step records of ``batch`` trajectories, through the port's step
    on its own weights, on the JAX package's (the JAX dd filter's stand-in:
    on GH-9 the two agree to 3.4e-11, :func:`test_gpq_gh9_against_jax_dd_filter`;
    the JAX dd filter on 15 points had not compiled after 35 minutes on the
    CPU) and on the exact ones: the share of runs finite throughout, and the
    max |difference| of the filtered means from the port's at step 1 and
    over all steps, on the runs finite in both."""
    import dataclasses
    (_, _, jalg), _ = _gpq_pair(deg)
    alg = _rule(*_system("ungm", meas), f"gpq_gh{deg}")
    params = sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    y = _records(("ungm", meas, f"gpq_gh{deg}"), batch)
    c = sf.step_consts(params, T, "cpu")
    runs = {"port": (params.dyn, params.obs),
            "jax": (_with_weights(params.dyn, _jax_weights(jalg.tf_dyn)),
                    _with_weights(params.obs, _jax_weights(jalg.tf_obs))),
            "exact": (_with_weights(params.dyn, _exact_weights(alg.tf_dyn)),
                      _with_weights(params.obs, _exact_weights(alg.tf_obs)))}
    means = {k: sf._scalar_filter_plain(dataclasses.replace(params, dyn=d, obs=o), y,
                                        c)[0].numpy() for k, (d, o) in runs.items()}
    out = {f"finite_{k}": float(np.isfinite(m).all(0).mean()) for k, m in means.items()}
    for k in ("jax", "exact"):
        both = np.isfinite(means["port"]).all(0) & np.isfinite(means[k]).all(0)
        gap = np.abs(means["port"][:, both] - means[k][:, both])
        out[f"{k}_step1"], out[f"{k}_all"] = ((float(gap[0].max()), float(gap.max()))
                                              if both.any() else (math.nan, math.nan))
    return out


@pytest.mark.parametrize("deg", GPQ_DEGREES)
def test_gpq_weights_against_exact(deg):
    """GPQ on 9, 15 and 16 Gauss-Hermite points (``KPAR``): the Gram's
    condition number is 3.0e7, 7.5e8 and 7.8e8, and neither package's
    ``Wc`` is the exact ``K^-1 Q K^-1`` of the same float64 Gram (max |Wc|
    0.37, 0.43, 0.25): max |Wc - exact| is 5.0e-4 / 0.45 / 0.11 in the port
    (``wm wm^T + K^-1 (Q - q q^T) K^-1``) and 8.1e-4 / 0.36 / 0.44 in the
    JAX package (``K^-1 Q K^-1``).  The centred sum, -1.0e-10 / 1.6e-11 /
    1.2e-10 for the exact weights, is 1.5e-9 / -1.8e-8 / 2.2e-7 in the port
    and 1.8e-7 / -8.2e-6 / -1.3e-5 in the JAX package: the port's is nearer
    at every count, by 61x and more (readings: ``python
    tests/test_torch_sf_slots.py``)."""
    r = gpq_weight_readings(deg)
    assert r["cond"] > 1e7
    assert (abs(r["centred_port"] - r["centred_exact"])
            < abs(r["centred_jax"] - r["centred_exact"]) / 10), r


def test_gpq_gh9_against_jax_dd_filter():
    """UNGM under GPQ on GH-9 points, 20 steps of 4 trajectories, against
    the JAX package's dd filter.  With each package's own weights the
    filtered means part by 1.8e-4 at step 1 and by up to 12.9 (step 18):
    the stated gap, which the UNGM filter grows from the weights'.  With the
    JAX package's weights put into the port's step they agree to 3.4e-11
    over all 20 steps: the gap is the weights alone.  At step 1 the port's
    filter lies 7.7e-7 from the same filter on the exact weights
    (:func:`_exact_weights`), the JAX package's 1.8e-4: the gap starts in
    the reference's weights (readings: ``python
    tests/test_torch_sf_slots.py``)."""
    r = gpq_filter_readings(9)
    assert r["finite_port"] == r["finite_jax"] == r["finite_exact"] == 1.0
    assert r["same"].max() <= 1e-10, r["same"]
    assert r["own"][0] <= 2e-4 and r["own"].max() <= 13.0, r["own"]
    assert r["port_exact"][0] < r["jax_exact"][0] / 10, r


def test_gpq_gh15_keeps_runs_the_reference_weights_lose():
    """UNGM under GPQ on GH-15 points, 200 records of 30 steps, through the
    port's step: on the port's own weights and on the exact ones every run
    stays finite; on the JAX package's weights nearly all are lost (2.6% of
    1,000 runs finite in the readings), the reference's conditioning at
    work."""
    r = gpq_proxy_readings(15, "ungm", batch=200)
    assert r["finite_port"] == r["finite_exact"] == 1.0, r
    assert r["finite_jax"] < 0.1, r


if __name__ == "__main__":
    # The GPQ readings of the tests above, ROADMAP.md and PERF.md:
    #     python tests/test_torch_sf_slots.py
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401  (the suite's JAX settings: CPU, float64, its XLA flags)
    set_device("cpu")
    torch.set_num_threads(1)
    for deg in GPQ_DEGREES:
        print(f"GPQ-GH{deg} weights:", {k: f"{v:.3e}" for k, v in gpq_weight_readings(deg).items()},
              flush=True)
    r = gpq_filter_readings(9)
    print("GPQ-GH9 filter against the JAX dd filter, 4 x 20:",
          {k: (f"{v:.4f}" if np.ndim(v) == 0 else f"step 1 {v[0]:.3e}, all {np.nanmax(v):.3e}")
           for k, v in r.items()}, flush=True)
    for deg in GPQ_DEGREES:
        for meas in ("ungm", "sine"):
            print(f"GPQ-GH{deg} {meas}, 1000 x {T}, the port's step on each package's and "
                  "the exact weights:",
                  {k: f"{v:.4g}" for k, v in gpq_proxy_readings(deg, meas).items()}, flush=True)
