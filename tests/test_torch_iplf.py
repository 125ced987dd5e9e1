"""The time-parallel iterated posterior-linearization smoother of the PyTorch
port (``ssmtoybox_torch/parallel/iplf.py``) against the JAX package's
``ssmtoybox_tpu/parallel/iplf.py``.

The same measurements (simulated by the port on the CPU from a seed) go
through both packages; each JAX configuration is one ``jax.jit`` compile,
made on first use, so that a worker computes only the ones its tests need.
Tolerances, relative to each stream's largest entry: float64 1e-10; GPQ
1e-8 (each package builds its own weights); float32 against the JAX
package's float32 1e-4 (sums in another order; the port evaluates the
models in float64).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssmtoybox_tpu import mtran as jmtran
from ssmtoybox_tpu import ssmod as jssmod
from ssmtoybox_tpu.bq.gpqd import GaussianProcessDerTransform as JGPQD
from ssmtoybox_tpu.bq.transforms import GaussianProcessTransform as JGPT
from ssmtoybox_tpu.parallel import iterated_parallel_smoother as jips
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import convert, mtran, ssmod
from ssmtoybox_torch.bq.transforms import GaussianProcessTransform
from ssmtoybox_torch.parallel import IteratedSmootherResult, iterated_parallel_smoother, make_mesh
from ssmtoybox_torch.utils import GaussRV
from ssmtoybox_torch import set_device

TOL = 1e-10
BQ_TOL = 1e-8
F32_JAX_TOL = 1e-4
STEPS = 64
DT = 0.01
Q = 0.1 * np.array([[DT ** 3 / 3, DT ** 2 / 2], [DT ** 2 / 2, DT]])
FIELDS = ("fi_mean", "fi_cov", "sm_mean", "sm_cov")


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


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(a, b, tol, label=""):
    """``|a - b| <= tol max |b|``."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-300),
                               err_msg=label)


def _pendulum():
    dyn = ssmod.Pendulum2DTransition(GaussRV(2, mean=[1.5, 0.0], cov=0.01 * np.eye(2)),
                                     GaussRV(2, cov=Q), dt=DT)
    obs = ssmod.Pendulum2DMeasurement(GaussRV(1, cov=0.1), dim_state=2)
    jdyn = jssmod.Pendulum2DTransition.create(
        JGaussRV.create(2, mean=np.array([1.5, 0.0]), cov=0.01 * np.eye(2)),
        JGaussRV.create(2, cov=Q), dt=DT)
    jobs = jssmod.Pendulum2DMeasurement.create(JGaussRV.create(1, cov=0.1), dim_state=2)
    return dyn, obs, jdyn, jobs


def _ungm_na(ignore_time=False):
    class Dyn(ssmod.UNGMNATransition):
        def dyn_fcn(self, x, q, time):
            return super().dyn_fcn(x, q, 0 * time if ignore_time else time)

    dyn = Dyn(GaussRV(1, mean=1.0, cov=1.0), GaussRV(1, cov=10.0))
    obs = ssmod.UNGMNAMeasurement(GaussRV(1, cov=0.01), dim_state=1)
    jdyn = jssmod.UNGMNATransition.create(JGaussRV.create(1, mean=1.0, cov=1.0),
                                          JGaussRV.create(1, cov=10.0))
    jobs = jssmod.UNGMNAMeasurement.create(JGaussRV.create(1, cov=0.01), dim_state=1)
    return dyn, obs, jdyn, jobs


def _record(dyn, obs, steps, seed):
    gen = torch.Generator().manual_seed(seed)
    x = dyn.simulate_discrete(gen, steps=steps, mc_sims=1)
    return obs.simulate_measurements(gen, x)[..., 0].numpy()              # (dim_y, N)


#: the configurations held against the JAX package: the init modes, each
#: with one more option of the smoother, so that each is one JAX compile
CONFIGS = {
    "observer": dict(),
    "block-observer, sqrt": dict(init="block-observer", block_len=16, warmup=8, sqrt=True),
    "rollout, sqrt float32": dict(init="rollout", sqrt=True, dtype="float32", chol_jitter=1e-7),
    "prior, GPQ": dict(init="prior", gpq=True),
    "array": dict(init="array"),
}


def _transforms(kw, torch_side):
    if kw.get("gpq"):
        par = np.array([[1.0, 3.0, 3.0]])
        if torch_side:
            return GaussianProcessTransform(2, 2, par), GaussianProcessTransform(2, 1, par)
        return JGPT.create(2, 2, par), JGPT.create(2, 1, par)
    ut = mtran.UnscentedTransform(2) if torch_side else jmtran.UnscentedTransform(2)
    return ut, ut


def _kwargs(kw, torch_side, n, d):
    out = {k: v for k, v in kw.items() if k != "gpq"}
    if out.get("dtype") == "float32":
        out["dtype"] = torch.float32 if torch_side else jnp.float32
    if out.get("init") == "array":
        # a linearization trajectory of times 0..N, away from the truth
        traj = np.stack([1.5 - 0.01 * np.arange(n + 1), np.zeros(n + 1)], axis=1)[:, :d]
        out["init"] = torch.from_numpy(traj) if torch_side else jnp.asarray(traj)
    return out


@functools.lru_cache(maxsize=None)
def _pendulum_case(name):
    """``(port models, data, the JAX package's result)`` of a configuration."""
    dyn, obs, jdyn, jobs = _pendulum()
    y = _record(dyn, obs, STEPS, 2)
    kw = CONFIGS[name]
    tf_d, tf_o = _transforms(kw, torch_side=False)
    jkw = _kwargs(kw, False, STEPS, 2)
    run = jax.jit(lambda yy: jips(jdyn, jobs, tf_d, tf_o, yy, iterations=2, **jkw))
    return (dyn, obs), y, run(jnp.asarray(y))


@functools.lru_cache(maxsize=None)
def _ungm_na_case():
    dyn, obs, jdyn, jobs = _ungm_na()
    y = _record(dyn, obs, 24, 9)
    ut = jmtran.UnscentedTransform(2)
    want = jax.jit(lambda yy: jips(jdyn, jobs, ut, ut, yy, iterations=2))(jnp.asarray(y))
    return y, want


@pytest.mark.parametrize("name", list(CONFIGS))
def test_smoother_matches_jax(name):
    (dyn, obs), y, want = _pendulum_case(name)
    kw = CONFIGS[name]
    tf_d, tf_o = _transforms(kw, torch_side=True)
    got = iterated_parallel_smoother(dyn, obs, tf_d, tf_o, torch.from_numpy(y), iterations=2,
                                     **_kwargs(kw, True, STEPS, 2))
    assert isinstance(got, IteratedSmootherResult)
    tol = F32_JAX_TOL if kw.get("dtype") else BQ_TOL if kw.get("gpq") else TOL
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert tuple(g.shape) == w.shape, f
        assert g.dtype == (torch.float32 if kw.get("dtype") else torch.float64), f
        _close(g, w, tol, f"{name} {f}")


def test_nonadditive_time_varying_ungm_matches_jax():
    """UNGM with non-additive noise in both models (``8 q cos(1.2 k)``): each
    step's SLR must see its own time.  The same model with every step at
    time 0 lands far from the JAX package's result, so the match is not
    one of a model that ignores its time."""
    y, want = _ungm_na_case()
    ut = mtran.UnscentedTransform(2)
    dyn, obs, _, _ = _ungm_na()
    got = iterated_parallel_smoother(dyn, obs, ut, ut, torch.from_numpy(y), iterations=2)
    for f in FIELDS:
        _close(getattr(got, f), getattr(want, f), TOL, f)
    dyn0, obs0, _, _ = _ungm_na(ignore_time=True)
    at_zero = iterated_parallel_smoother(dyn0, obs0, ut, ut, torch.from_numpy(y), iterations=2)
    gap = np.abs(_np(at_zero.sm_mean) - np.asarray(want.sm_mean)).max()
    assert gap > 1e-3 * np.abs(np.asarray(want.sm_mean)).max()


class LinearPositionMeasurement(ssmod.MeasurementModel):
    """``y = [p_x, p_y] + r``: linear, so SLR recovers it exactly."""
    dim_substate, dim_out, dim_noise = 4, 2, 2

    def meas_fcn(self, x, r, time):
        return torch.stack([x[..., 0], x[..., 2]], dim=-1) + r


def test_linear_model_one_iteration_is_the_sequential_ukf_and_rts():
    """On a linear model one iteration is the port's sequential UKF and RTS
    smoother, in both scan forms, and a second iteration is a fixed point."""
    x0 = GaussRV(4, mean=[100.0, 10.0, -50.0, 4.0], cov=np.diag([100.0, 25.0, 100.0, 25.0]))
    dyn = ssmod.ConstantVelocity(x0, GaussRV(2, cov=np.diag([5.0, 5.0])), dt=0.5)
    obs = LinearPositionMeasurement(GaussRV(2, cov=np.diag([20.0, 20.0])), dim_state=4)
    y = torch.from_numpy(_record(dyn, obs, 48, 4))
    ut = mtran.UnscentedTransform(4)
    seq = stt.gaussian_filter_batch(dyn, obs, ut, ut, y[None])
    sm, sP = stt.gaussian_smoother(seq, rts_full=True)
    for sqrt in (False, True):
        r1 = iterated_parallel_smoother(dyn, obs, ut, ut, y, iterations=1, sqrt=sqrt)
        for got, want in ((r1.fi_mean, seq.fi_mean[0]), (r1.fi_cov, seq.fi_cov[0]),
                          (r1.sm_mean, sm[0]), (r1.sm_cov, sP[0])):
            _close(got, want, 1e-9, f"sqrt={sqrt}")
    r2 = iterated_parallel_smoother(dyn, obs, ut, ut, y, iterations=2)
    _close(r2.sm_mean, sm[0], 1e-9, "fixed point")


def test_kernel_parameters_of_the_bq_transforms():
    """``theta_dyn``/``theta_obs`` at the construction parameters give the
    construction weights' result; other parameters move it."""
    dyn, obs, _, _ = _pendulum()
    y = torch.from_numpy(_record(dyn, obs, 32, 6))
    par = np.array([[1.0, 3.0, 3.0]])
    tf_d, tf_o = GaussianProcessTransform(2, 2, par), GaussianProcessTransform(2, 1, par)
    run = lambda **kw: iterated_parallel_smoother(dyn, obs, tf_d, tf_o, y, iterations=1,
                                                  init="prior", **kw)
    base, theta = run(), torch.from_numpy(par)
    same = run(theta_dyn=theta, theta_obs=theta)
    for f in FIELDS:
        _close(getattr(same, f), getattr(base, f), 1e-12, f)
    other = run(theta_dyn=2.0 * theta, theta_obs=theta)
    assert np.abs(_np(other.sm_mean) - _np(base.sm_mean)).max() > 1e-6


@pytest.mark.parametrize("bad, error", [
    (dict(init="bogus"), ValueError),
    (dict(init=np.zeros((5, 2))), ValueError),
    (dict(scan_block_len=16), ValueError),
    (dict(iterations=0), ValueError),
    (dict(mesh="world of one", scan_block_len=16, sqrt=True), ValueError),
])
def test_refused_arguments(bad, error):
    dyn, obs, _, _ = _pendulum()
    y = torch.from_numpy(_record(dyn, obs, 8, 1))
    kw = dict(bad)
    if kw.get("mesh") == "world of one":
        kw["mesh"] = make_mesh()
    tf = mtran.UnscentedTransform(2)
    kw.setdefault("iterations", 1)
    with pytest.raises(error):
        iterated_parallel_smoother(dyn, obs, tf, tf, y, **kw)


#: the linearizing transforms on the UNGM models, whose dynamics depend on
#: the time: each row's Jacobian is taken at its own step's time.  GPQ+D takes
#: the JAX transform's weights (the Gram is ill-conditioned: weights built by
#: each package differ by ~1e-6); Taylor-GPQ+D in square-root form (its full
#: form gives NaN on this record in both packages)
LINEARIZING = {
    "linearization": (False, lambda: (jmtran.LinearizationTransform.create(1),) * 2),
    "linearization, sqrt": (True, lambda: (jmtran.LinearizationTransform.create(1),) * 2),
    "taylor-gpqd, sqrt": (True, lambda: (jmtran.TaylorGPQDTransform.create(1, TAYLOR_PAR),) * 2),
    "gpqd": (False, lambda: (JGPQD.create(1, 1, np.array([[1.0, 3.0]]), point_str="ut"),) * 2),
}
TAYLOR_PAR = np.array([[1.0, 1.0]])
LIN_STEPS = 20


def _port_transform(jtf):
    if isinstance(jtf, jmtran.LinearizationTransform):
        return mtran.LinearizationTransform(1)
    if isinstance(jtf, jmtran.TaylorGPQDTransform):
        return mtran.TaylorGPQDTransform(1, TAYLOR_PAR)
    keys = ("wm", "Wc", "Wcc", "model_var", "iK", "integral_var")
    return convert.transform_from_numpy(
        {**{k: np.asarray(getattr(jtf, k)) for k in keys}, "dim_out": jtf.dim_out,
         "points": np.asarray(jtf.model.points), "which_der": np.asarray(jtf.model.which_der)})


@functools.lru_cache(maxsize=None)
def _linearizing_runs():
    """The UNGM record, the linearization trajectory (the truth plus
    noise) and the JAX package's IPLS(3) of every case of
    :data:`LINEARIZING`, from one ``jax.jit`` compile."""
    dyn = ssmod.UNGMTransition(GaussRV(1, cov=5.0), GaussRV(1, cov=10.0))
    obs = ssmod.UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1)
    jdyn = jssmod.UNGMTransition.create(JGaussRV.create(1, cov=5.0), JGaussRV.create(1, cov=10.0))
    jobs = jssmod.UNGMMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1)
    gen = torch.Generator().manual_seed(3)
    x = dyn.simulate_discrete(gen, steps=LIN_STEPS, mc_sims=1)
    y = obs.simulate_measurements(gen, x)[..., 0].numpy()
    traj = (np.concatenate([[0.0], x[0, :, 0].numpy()])
            + np.random.default_rng(0).normal(size=LIN_STEPS + 1))[:, None]
    tfs = {name: make() for name, (_, make) in LINEARIZING.items()}

    @jax.jit
    def run(yy, tr):
        return {name: jips(jdyn, jobs, *tfs[name], yy, iterations=3, init=tr, sqrt=sq)
                for name, (sq, _) in LINEARIZING.items()}

    return (dyn, obs, y, traj, tfs), run(jnp.asarray(y), jnp.asarray(traj))


@pytest.mark.parametrize("name", list(LINEARIZING))
def test_linearizing_transforms_match_jax(name):
    """``LinearizationTransform`` (the parallel iterated extended smoother),
    Taylor-GPQ+D and GPQ+D in both models on a time-varying record."""
    (dyn, obs, y, traj, tfs), want = _linearizing_runs()
    tf = _port_transform(tfs[name][0])
    got = iterated_parallel_smoother(dyn, obs, tf, tf, torch.from_numpy(y), iterations=3,
                                     init=torch.from_numpy(traj), sqrt=LINEARIZING[name][0])
    for f in FIELDS:
        _close(getattr(got, f), getattr(want[name], f), BQ_TOL, f"{name} {f}")
