"""The classical moment transforms and the filters built on them in the
PyTorch port: linearization, Monte Carlo, the truncated sigma-point rules,
the single-point GPQ+D ("Taylor") transform, the KL metrics, the extended,
truncated and Taylor-GPQ+D Kalman filters and the extended Student filter,
and ``convert`` for every model and the new transform kinds.

Tolerances:

- goldens (``transforms2.npz``, ``ungm.npz``, ``metrics.npz``) at
  ``tests/test_parity.py``'s 1e-8;
- the JAX package's transforms on one batch of 3 inputs from a numpy seed at
  1e-12 (float64 on both sides; the Jacobians are forward-mode on both), its
  Monte-Carlo points bit for bit (the same NumPy generator);
- the JAX package's filters and smoothers on 20-30 steps at 1e-10;
- model functions loaded through ``convert`` against the JAX model's at
  1e-12.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu import mtran as jmtran
from ssmtoybox_tpu import points as jpoints
from ssmtoybox_tpu import ssmod as jssmod
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
from ssmtoybox_tpu.utils import StudentRV as JStudentRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import convert, mtran, points, set_device, ssmod
from ssmtoybox_torch.ops import scalar_filter as sf, vector_filter as vf
from ssmtoybox_torch.utils import GaussRV, StudentRV
from ssmtoybox_torch.utils import metrics


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


PARITY = 1e-8
JAX_TF = 1e-12
JAX_FILTER = 1e-10
FIELDS = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def p2c(x, time):
    """Polar to cartesian, the goldens' integrand (extra inputs ignored)."""
    return x[..., :1] * torch.stack([torch.cos(x[..., 1]), torch.sin(x[..., 1])], dim=-1)


def jp2c(x, pars):
    return x[0] * jnp.stack([jnp.cos(x[1]), jnp.sin(x[1])])


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def test_mc_points_are_the_jax_packages():
    for dim, n, seed in ((2, 1000, 1), (3, 7, 0), (1, 5, 42)):
        np.testing.assert_array_equal(points.mc_points(dim, n, seed),
                                      jpoints.mc_points(dim, n, seed))
        assert points.mc_weights(n) == jpoints.mc_weights(n)
    tf = mtran.MonteCarloTransform.create(2, n=1000, seed=1)
    np.testing.assert_array_equal(tf.unit_sp.numpy(),
                                  np.asarray(jmtran.MonteCarloTransform.create(2, 1000, 1).unit_sp))


#: golden key -> (port transform, input dimension of the golden's moments)
GOLDEN_TRANSFORMS = {
    "lin": (lambda g: mtran.LinearizationTransform(2), 2),
    "tay": (lambda g: mtran.TaylorGPQDTransform(2, g["tay_par"]), 2),
    "tut": (lambda g: mtran.TruncatedUnscentedTransform(3, 2), 3),
    "tsr": (lambda g: mtran.TruncatedSphericalRadialTransform(3, 2), 3),
    "tgh": (lambda g: mtran.TruncatedGaussHermiteTransform(3, 2, degree=3), 3),
}


@pytest.mark.parametrize("key", sorted(GOLDEN_TRANSFORMS))
def test_transform_matches_golden(goldens, key):
    g = goldens["transforms2"]
    make, dim = GOLDEN_TRANSFORMS[key]
    mf, cf, ccf = make(g).apply(p2c, torch.as_tensor(g[f"mean{dim}"])[None],
                                torch.as_tensor(g[f"cov{dim}"])[None], 0)
    _close(mf[0], g[f"{key}_mf"], PARITY, f"{key} mean")
    _close(cf[0], g[f"{key}_cf"], PARITY, f"{key} cov")
    # every entry of the Taylor cov_f carries the model variance (the golden's
    # off-diagonal entries too); its cross-covariance is (E, D), the
    # reference's transposed
    want = g[f"{key}_ccf"].T if key == "tay" else g[f"{key}_ccf"]
    _close(ccf[0], want, PARITY, f"{key} cross-covariance")


#: name -> (port transform, JAX transform, input dimension)
JAX_TRANSFORMS = {
    "lin": (lambda: mtran.LinearizationTransform(3),
            lambda: jmtran.LinearizationTransform.create(3), 3),
    "mc": (lambda: mtran.MonteCarloTransform.create(3, n=200, seed=4),
           lambda: jmtran.MonteCarloTransform.create(3, n=200, seed=4), 3),
    "tut": (lambda: mtran.TruncatedUnscentedTransform(4, 2),
            lambda: jmtran.TruncatedUnscentedTransform(4, 2), 4),
    "tsr": (lambda: mtran.TruncatedSphericalRadialTransform(4, 3),
            lambda: jmtran.TruncatedSphericalRadialTransform(4, 3), 4),
    "tgh": (lambda: mtran.TruncatedGaussHermiteTransform(3, 2, degree=4),
            lambda: jmtran.TruncatedGaussHermiteTransform(3, 2, degree=4), 3),
    "tay": (lambda: mtran.TaylorGPQDTransform(3, [[1.3, 0.8, 2.0, 3.0]]),
            lambda: jmtran.TaylorGPQDTransform.create(3, np.array([[1.3, 0.8, 2.0, 3.0]])), 3),
}


def _inputs(dim, seed=0, batch=3):
    rng = np.random.default_rng(seed)
    mean = np.column_stack([1.0 + 0.2 * rng.random(batch), rng.uniform(-1, 1, batch),
                            rng.normal(size=(batch, dim - 2))])
    a = 0.3 * rng.normal(size=(batch, dim, dim))
    cov = a @ a.transpose(0, 2, 1) + np.diag([0.01, 0.1] + [0.5] * (dim - 2))
    return mean, cov


@pytest.fixture(scope="module")
def jax_transformed():
    """Every JAX transform of ``JAX_TRANSFORMS`` on its batch, in one
    compiled program."""
    tfs = {name: make_jax() for name, (_, make_jax, _) in JAX_TRANSFORMS.items()}
    inputs = {name: tuple(map(jnp.asarray, _inputs(dim, seed=len(name))))
              for name, (_, _, dim) in JAX_TRANSFORMS.items()}
    run = jax.jit(lambda ins: {name: jax.vmap(lambda m, c: tfs[name].apply(jp2c, m, c, None))(
        *ins[name]) for name in tfs})
    return run(inputs)


@pytest.mark.parametrize("name", sorted(JAX_TRANSFORMS))
def test_transform_matches_jax_on_a_batch(jax_transformed, name):
    make, _, dim = JAX_TRANSFORMS[name]
    mean, cov = _inputs(dim, seed=len(name))
    got = make().apply(p2c, torch.as_tensor(mean), torch.as_tensor(cov), 0)
    for g_, w_, what in zip(got, jax_transformed[name], ("mean", "cov", "cross-covariance")):
        assert g_.shape == w_.shape, what
        _close(g_, w_, JAX_TF, f"{name} {what}")


def test_truncated_transform_is_no_sigma_point_transform():
    """The fused filters take any SigmaPointTransform as one rule; the
    truncated one has two."""
    tf = mtran.TruncatedUnscentedTransform(3, 2)
    assert not isinstance(tf, mtran.SigmaPointTransform)
    assert isinstance(tf, mtran.MomentTransform)


def test_truncated_filter_on_nonadditive_measurement_fails_in_both_packages():
    """The measurement rule is built on ``obs.dim_state``; non-additive noise
    augments the input past it.  The JAX package's product fails; the port
    says why."""
    y = np.ones((1, 5))
    jdyn = jssmod.UNGMTransition.create(JGaussRV.create(1, cov=1.0), JGaussRV.create(1, cov=10.0))
    jobs = jssmod.UNGMNAMeasurement.create(JGaussRV.create(1, cov=0.01), dim_state=1)
    with pytest.raises(TypeError):
        st.ssinf.TruncatedGaussHermiteKalman(jdyn, jobs).forward_pass(jnp.asarray(y))
    dyn = ssmod.UNGMTransition(GaussRV(1, cov=1.0), GaussRV(1, cov=10.0))
    obs = ssmod.UNGMNAMeasurement(GaussRV(1, cov=0.01), dim_state=1)
    for make in (stt.TruncatedGaussHermiteKalman, stt.TruncatedUnscentedKalman,
                 stt.TruncatedCubatureKalman):
        with pytest.raises(ValueError, match="truncated rule is of dimension 1"):
            make(dyn, obs).forward_pass(y)


# ---------------------------------------------------------------------------
# KL metrics
# ---------------------------------------------------------------------------

def test_kl_metrics_match_golden(goldens):
    g = goldens["metrics"]
    x, m, P, MSE = (torch.as_tensor(g[k]) for k in ("x", "m", "P", "MSE"))
    _close(metrics.kl_divergence(x, P, m, MSE), g["kl"][0], PARITY, "kl")
    _close(metrics.symmetrized_kl_divergence(x, P, m, MSE), g["skl"][0], PARITY, "skl")


def test_kl_metrics_on_a_batch():
    """Over leading dimensions, against the closed form in NumPy: the default
    keeps the reference's flipped log-determinant term, ``False`` gives the
    true (non-negative) divergence, and the symmetrized one is the same
    either way."""
    rng = np.random.default_rng(7)
    m0, m1 = rng.normal(size=(2, 4, 3))
    a, b = rng.normal(size=(2, 4, 3, 3))
    c0, c1 = a @ a.transpose(0, 2, 1) + np.eye(3), b @ b.transpose(0, 2, 1) + np.eye(3)
    dmu = m0 - m1
    tr = np.trace(np.linalg.solve(c1, c0), axis1=-2, axis2=-1)
    quad = np.einsum("bi,bi->b", dmu, np.linalg.solve(c1, dmu[..., None])[..., 0])
    logdet = np.linalg.slogdet(c1)[1] - np.linalg.slogdet(c0)[1]
    true_kl = 0.5 * (tr + quad + logdet - 3)
    args = [torch.as_tensor(v) for v in (m0, c0, m1, c1)]
    _close(metrics.kl_divergence(*args, compat_flipped_logdet=False), true_kl, JAX_TF, "kl")
    _close(metrics.kl_divergence(*args), true_kl - logdet, JAX_TF, "kl, flipped")
    flipped = metrics.kl_divergence(*args[2:], *args[:2], compat_flipped_logdet=False)
    _close(metrics.symmetrized_kl_divergence(*args),
           0.5 * (true_kl + flipped.numpy()), JAX_TF, "skl")
    assert bool((true_kl >= 0).all())


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

def _ungm(q=10.0):
    return (ssmod.UNGMTransition(GaussRV(1, cov=1.0), GaussRV(1, cov=q)),
            ssmod.UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1))


def _jungm(q=10.0):
    return (jssmod.UNGMTransition.create(JGaussRV.create(1, cov=1.0), JGaussRV.create(1, cov=q)),
            jssmod.UNGMMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1))


KPAR = np.array([[1.0, 3.0]])


@pytest.mark.parametrize("key,make", [
    ("ekf", stt.ExtendedKalman),
    ("ekf_gpqd", lambda d, o: stt.ExtendedKalmanGPQD(d, o, KPAR, KPAR)),
    ("ckf", stt.TruncatedCubatureKalman)])
def test_filter_matches_golden(goldens, key, make):
    """The first 30 of the golden's 100 steps (a filtered estimate reads the
    data up to its step only).  On UNGM the truncated CKF's measurement rule
    is the full one (``obs.dim_in == obs.dim_state``), so the reference's
    CKF is its golden."""
    g = goldens["ungm"]
    alg = make(*_ungm())
    fm, fP = alg.forward_pass(g["y"][:, :30, 0])
    _close(fm, g[f"{key}_fm"][..., :30], PARITY, f"{key} filtered mean")
    _close(fP, g[f"{key}_fP"][..., :30], PARITY, f"{key} filtered cov")


def _ungm_na_dyn():
    """The system of the JAX package's truncated-GH regression test:
    non-additive UNGM dynamics, additive UNGM measurement."""
    return ((ssmod.UNGMNATransition(GaussRV(1, mean=1.0, cov=1.0), GaussRV(1, cov=1.0)),
             ssmod.UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1)),
            (jssmod.UNGMNATransition.create(JGaussRV.create(1, mean=1.0, cov=1.0),
                                            JGaussRV.create(1, cov=1.0)),
             jssmod.UNGMMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1)))


def _records(dyn, obs, seed, batch=2, steps=24):
    gen = torch.Generator().manual_seed(seed)
    return obs.simulate_measurements(gen, dyn.simulate_discrete(gen, steps, batch)).permute(2, 0, 1)


def _student_ungm():
    """The ``ungm_student.npz`` system (that golden holds FSQ only)."""
    return ((ssmod.UNGMTransition(StudentRV(1, scale=1.0, dof=4.0),
                                  StudentRV(1, scale=10.0, dof=4.0)),
             ssmod.UNGMMeasurement(StudentRV(1, scale=0.01, dof=4.0), dim_state=1)),
            (jssmod.UNGMTransition.create(JStudentRV.create(1, scale=1.0, dof=4.0),
                                          JStudentRV.create(1, scale=10.0, dof=4.0)),
             jssmod.UNGMMeasurement.create(JStudentRV.create(1, scale=0.01, dof=4.0),
                                           dim_state=1)))


#: name -> (system, port filter, JAX filter, records' seed); every one runs
#: 2 records of 24 steps
FILTERS = {
    "tukf": (lambda: (_ungm(), _jungm()), stt.TruncatedUnscentedKalman,
             st.ssinf.TruncatedUnscentedKalman, 1),
    "tghkf3_ungm_na": (_ungm_na_dyn, stt.TruncatedGaussHermiteKalman,
                       st.ssinf.TruncatedGaussHermiteKalman, 3),
    "extended_student": (_student_ungm, stt.ExtendedStudent, st.ExtendedStudent, 4),
}


@pytest.fixture(scope="module")
def jax_filtered():
    """Each JAX filter of ``FILTERS`` and its smoother on the port's records,
    in one compiled program; with the port's filter objects and records."""
    algs, jalgs, ys = {}, {}, {}
    for name, (system, make, make_jax, seed) in FILTERS.items():
        (dyn, obs), (jdyn, jobs) = system()
        algs[name], jalgs[name] = make(dyn, obs), make_jax(jdyn, jobs)
        ys[name] = _records(dyn, obs, seed=seed)

    def run(batches):
        out = {}
        for name, b in batches.items():
            a = jalgs[name]
            if isinstance(a, st.ssinf.StudentianInference):
                res = jax.vmap(lambda y: st.ssinf.studentian_filter(
                    a.mod_dyn, a.mod_obs, a.tf_dyn, a.tf_obs, y))(b)
                out[name] = (res, jax.vmap(st.ssinf.studentian_smoother)(res))
            else:
                res = st.gaussian_filter_batch(a.mod_dyn, a.mod_obs, a.tf_dyn, a.tf_obs, b)
                out[name] = (res, jax.vmap(st.gaussian_smoother)(res))
        return out

    ref = jax.jit(run)({k: jnp.asarray(v.numpy()) for k, v in ys.items()})
    return {name: (algs[name], ys[name]) + ref[name] for name in FILTERS}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_and_smoother_match_jax(jax_filtered, name):
    """Every stream of the filter and the RTS smoother (the scale-matrix one
    for the Student filter).  The JAX package's own smoke test leaves out the
    truncated UKF's smoother; here both packages' smoothers run, and
    agree."""
    alg, ys, ref, ref_sm = jax_filtered[name]
    res = alg.forward_pass_batch(ys)
    student = isinstance(alg, stt.StudentianInference)
    fields = (("fi_mean", "fi_cov", "fi_smat", "dof_fi", "pr_mean", "pr_smat", "pr_xx_smat")
              if student else FIELDS)
    for f in fields:
        _close(getattr(res, f), getattr(ref, f), JAX_FILTER, f"{name} {f}")
    sm = (stt.studentian_smoother if student else stt.gaussian_smoother)(res)
    for got, want, what in zip(sm, ref_sm, ("smoothed mean", "smoothed cov or scale")):
        assert bool(torch.isfinite(got).all())
        _close(got, want, JAX_FILTER, f"{name} {what}")


def _pendulum():
    dt = 0.01
    q = 0.1 * np.array([[dt ** 3 / 3, dt ** 2 / 2], [dt ** 2 / 2, dt]])
    return (ssmod.Pendulum2DTransition(GaussRV(2, mean=[1.5, 0.0], cov=0.01 * np.eye(2)),
                                       GaussRV(2, cov=q), dt=dt),
            ssmod.Pendulum2DMeasurement(GaussRV(1, cov=0.1), dim_state=2))


NEW_FILTERS = {
    "ekf": stt.ExtendedKalman,
    "tukf": stt.TruncatedUnscentedKalman,
    "tckf": stt.TruncatedCubatureKalman,
    "tghkf": stt.TruncatedGaussHermiteKalman,
    "ekf_gpqd": lambda d, o: stt.ExtendedKalmanGPQD(d, o, np.ones((1, d.dim_in + 1)),
                                                    np.ones((1, o.dim_state + 1))),
    "gpqdkf": lambda d, o: stt.GaussianProcessDerKalman(d, o, np.ones((1, d.dim_in + 1)),
                                                        np.ones((1, o.dim_in + 1))),
}


@pytest.mark.parametrize("name,system", [(name, "ungm") for name in sorted(NEW_FILTERS)]
                         + [("ekf", "pendulum"), ("gpqdkf", "pendulum")])
def test_fused_engine_refuses_and_auto_is_f64(name, system):
    """No fused kernel takes these transforms: ``engine="dd"`` raises with the
    reason, ``"auto"`` gives the ``"f64"`` bits, and neither launches (on
    the CPU: calls the plain version of) a kernel."""
    dyn, obs = _ungm() if system == "ungm" else _pendulum()
    alg = NEW_FILTERS[name](dyn, obs)
    ys = _records(dyn, obs, seed=5, steps=6)
    lowering = sf if system == "ungm" else vf
    with pytest.raises(ValueError, match="engine='dd' cannot run this configuration"):
        alg.forward_pass_batch(ys, engine="dd")
    assert not lowering.supports(dyn, obs, alg.tf_dyn, alg.tf_obs)
    calls = {"sf": 0, "vf": 0}
    plain = (sf._scalar_filter_plain, vf._vector_filter_plain)

    def counted(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    try:
        sf._scalar_filter_plain = counted("sf", plain[0])
        vf._vector_filter_plain = counted("vf", plain[1])
        launches = (sf.LAUNCHES, vf.LAUNCHES)
        auto = alg.forward_pass_batch(ys, engine="auto")
        f64 = alg.forward_pass_batch(ys, engine="f64")
    finally:
        sf._scalar_filter_plain, vf._vector_filter_plain = plain
    assert calls == {"sf": 0, "vf": 0} and (sf.LAUNCHES, vf.LAUNCHES) == launches
    for f in FIELDS:
        assert torch.equal(getattr(auto, f), getattr(f64, f)), f


# ---------------------------------------------------------------------------
# device and convert
# ---------------------------------------------------------------------------

def _cpu(*shape):
    return torch.ones(shape, dtype=torch.float64)


#: constructors handed CPU tensors with ``device=None``, and a member each
#: that must land on the default device
BUILT_FROM_CPU_TENSORS = {
    "LinearizationTransform": (lambda: mtran.LinearizationTransform(2), "device"),
    "MonteCarloTransform": (lambda: mtran.MonteCarloTransform(_cpu(2, 5), 0.2, 0.25), "unit_sp"),
    "MonteCarloTransform.create": (lambda: mtran.MonteCarloTransform.create(2, 5), "unit_sp"),
    "TruncatedSigmaPointTransform": (
        lambda: mtran.TruncatedSigmaPointTransform(_cpu(1, 3), _cpu(3), _cpu(3, 3), _cpu(2, 5),
                                                   _cpu(5, 5), 1), "Wcc"),
    "TruncatedUnscentedTransform": (lambda: mtran.TruncatedUnscentedTransform(3, 2), "unit_sp"),
    "TaylorGPQDTransform": (lambda: mtran.TaylorGPQDTransform(2, _cpu(1, 3)), "ell"),
}


@pytest.mark.parametrize("name", sorted(BUILT_FROM_CPU_TENSORS))
def test_device_none_moves_cpu_tensors_to_the_default_device(name):
    make, member = BUILT_FROM_CPU_TENSORS[name]
    try:
        set_device("meta")
        obj = make()
    finally:
        set_device("cpu")
    got = getattr(obj, member)
    assert (got if isinstance(got, torch.device) else got.device).type == "meta"


def _arrays(jm):
    """A JAX model's arrays and fields, as a caller carries them across."""
    d = {"noise_mean": np.asarray(jm.noise_rv.mean), "noise_cov": np.asarray(jm.noise_rv.cov)}
    if hasattr(jm, "init_rv"):
        d.update(init_mean=np.asarray(jm.init_rv.mean), init_cov=np.asarray(jm.init_rv.cov),
                 noise_gain=np.asarray(jm.noise_gain))
    else:
        d.update(dim_state=jm.dim_state, state_index=jm.state_index)
    for k in convert._FIELDS.get(type(jm).__name__.rstrip("0123456789"), ()):
        d[k] = np.asarray(getattr(jm, k)) if k in ("sensor_pos", "radar_loc") else getattr(jm, k)
    return d


_SENSORS = np.array([[0.0, 0.0], [200.0, 0.0], [0.0, 200.0]])
#: kind -> the JAX model, built with fields off their defaults where it has them
JAX_MODELS = {
    "UNGMTransition": lambda g: jssmod.UNGMTransition.create(g(1, 0.5, 2.0), g(1, 0.0, 3.0)),
    "UNGMNATransition": lambda g: jssmod.UNGMNATransition.create(g(1, 1.0, 1.0), g(1, 0.0, 3.0)),
    "Pendulum2DTransition": lambda g: jssmod.Pendulum2DTransition.create(
        g(2, 1.5, 0.01), g(2, 0.0, 1e-3), dt=0.02, g=9.7),
    "ReentryVehicle1DTransition": lambda g: jssmod.ReentryVehicle1DTransition.create(
        g(3, 10.0, 0.09), g(3, 0.0, 1e-6), dt=0.2, Gamma=0.15),
    "ReentryVehicle2DTransition": lambda g: jssmod.ReentryVehicle2DTransition.create(
        g(5, 1.0, 1e-3), g(3, 0.0, 1e-6), dt=0.05, R0=6375.0, H0=13.5, Gm0=3.99e5, b0=-0.6),
    "CoordinatedTurnTransition": lambda g: jssmod.CoordinatedTurnTransition.create(
        g(5, 0.05, 1.0), g(5, 0.0, 0.1), dt=0.2),
    "ConstantTurnRateSpeed": lambda g: jssmod.ConstantTurnRateSpeed.create(
        g(5, 0.1, 0.1), g(2, 0.0, 0.1), dt=0.1, compat_heading=True),
    "ConstantVelocity": lambda g: jssmod.ConstantVelocity.create(g(4, 1.0, 1.0), g(2, 0.0, 0.5),
                                                                 dt=0.25),
    "UNGMMeasurement": lambda g: jssmod.UNGMMeasurement.create(g(1, 0.0, 2.0), dim_state=1),
    "UNGMNAMeasurement": lambda g: jssmod.UNGMNAMeasurement.create(g(1, 0.0, 0.01), dim_state=1),
    "Pendulum2DMeasurement": lambda g: jssmod.Pendulum2DMeasurement.create(g(1, 0.0, 0.1),
                                                                           dim_state=2),
    "RangeMeasurement": lambda g: jssmod.RangeMeasurement.create(g(1, 0.0, 0.03), dim_state=3,
                                                                 sx=20.0, sy=25.0),
    "BearingMeasurement": lambda g: jssmod.BearingMeasurement.create(
        g(3, 0.0, 1e-3), dim_state=5, state_index=[0, 2], sensor_pos=_SENSORS),
    "Radar2DMeasurement": lambda g: jssmod.Radar2DMeasurement.create(
        g(2, 0.0, 0.1), dim_state=4, state_index=[0, 2], radar_loc=np.array([3.0, -1.0])),
}


def test_every_model_class_is_carried():
    assert sorted(convert.MODELS) == sorted(JAX_MODELS)


def _model_inputs(jm):
    """States (and noise) of a JAX model from a numpy seed."""
    rng = np.random.default_rng(11)
    if hasattr(jm, "init_rv"):
        return (np.asarray(jm.init_rv.mean) + 0.1 * rng.normal(size=(6, jm.dim_state)),
                0.1 * rng.normal(size=(6, jm.dim_noise)))
    return (1.0 + rng.normal(size=(6, jm.dim_in)),)


@pytest.fixture(scope="module")
def jax_models():
    """Every model of ``JAX_MODELS``, its arrays, inputs and its function
    there (``dyn_fcn`` at time 3, or ``meas_eval``), in one compiled
    program."""
    models = {k: make(lambda n, m, c: JGaussRV.create(n, m * np.ones(n), c * np.eye(n)))
              for k, make in JAX_MODELS.items()}
    inputs = {k: _model_inputs(jm) for k, jm in models.items()}

    def run(ins):
        return {k: (jax.vmap(jm.dyn_fcn, in_axes=(0, 0, None))(*ins[k], 3)
                    if hasattr(jm, "init_rv") else
                    jax.vmap(jm.meas_eval, in_axes=(0, None))(*ins[k], 3))
                for k, jm in models.items()}

    out = jax.jit(run)({k: tuple(map(jnp.asarray, v)) for k, v in inputs.items()})
    return {k: (models[k], inputs[k], out[k]) for k in models}


@pytest.mark.parametrize("kind", sorted(JAX_MODELS))
def test_model_loaded_from_jax_arrays(jax_models, kind):
    """The model of each of the fourteen classes, loaded from a JAX model's
    arrays and fields (off their defaults), computes its function."""
    jm, inputs, want = jax_models[kind]
    tm = convert.model_from_numpy(kind, _arrays(jm))
    assert type(tm).__name__ == type(jm).__name__
    assert (tm.dim_in, tm.noise_additive) == (jm.dim_in, jm.noise_additive)
    args = [torch.as_tensor(v) for v in inputs]
    got = tm.dyn_fcn(*args, 3) if hasattr(jm, "init_rv") else tm.meas_eval(*args, 3)
    _close(got, want, 1e-12, "dyn_fcn" if hasattr(jm, "init_rv") else "meas_eval")


#: kind -> (JAX transform, the arrays a caller carries across, the port's own
#: twin, the port class)
TRANSFORM_KINDS = {
    "lin": (lambda: jmtran.LinearizationTransform.create(3), lambda tf: {"dim": tf.dim},
            lambda: mtran.LinearizationTransform(3), mtran.LinearizationTransform),
    "mc": (lambda: jmtran.MonteCarloTransform.create(3, n=50, seed=3),
           lambda tf: {"unit_sp": np.asarray(tf.unit_sp), "wm": tf.wm, "wc": tf.wc},
           lambda: mtran.MonteCarloTransform.create(3, n=50, seed=3), mtran.MonteCarloTransform),
    "trunc": (lambda: jmtran.TruncatedUnscentedTransform(3, 2),
              lambda tf: {**{k: np.asarray(getattr(tf, k)) for k in
                             ("unit_sp_eff", "wm", "Wc", "unit_sp", "Wcc")},
                          "dim_eff": tf.dim_eff},
              lambda: mtran.TruncatedUnscentedTransform(3, 2),
              mtran.TruncatedSigmaPointTransform),
    "taylor": (lambda: jmtran.TaylorGPQDTransform.create(3, np.array([[1.2, 0.7, 1.9, 2.5]])),
               lambda tf: {"alpha": np.asarray(tf.alpha), "ell": np.asarray(tf.ell),
                           "dim": tf.dim},
               lambda: mtran.TaylorGPQDTransform(3, [[1.2, 0.7, 1.9, 2.5]]),
               mtran.TaylorGPQDTransform),
}


@pytest.mark.parametrize("kind", sorted(TRANSFORM_KINDS))
def test_new_transform_kinds_load_from_jax_arrays(kind):
    """Each kind comes back as its own class (a truncated or Monte-Carlo dict
    has ``unit_sp`` too, and is no SigmaPointTransform), and transforms as
    the port's own twin does to the bit (the twin is held to the JAX
    package above)."""
    make_jax, arrays, make_twin, cls = TRANSFORM_KINDS[kind]
    tf = convert.transform_from_numpy(arrays(make_jax()))
    assert type(tf) is cls and not isinstance(tf, mtran.SigmaPointTransform)
    mean, cov = (torch.as_tensor(a) for a in _inputs(3, seed=9))
    for got, want in zip(tf.apply(p2c, mean, cov, 0), make_twin().apply(p2c, mean, cov, 0)):
        assert torch.equal(got, want)
