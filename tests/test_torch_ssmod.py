"""Main-path models and simulators of the PyTorch port against the JAX package.

The two packages draw from different generators (a torch.Generator against a
JAX key), so the simulators are compared two ways: the port's own draws are
replayed through the JAX model functions (same numbers in, 1e-9 out: float64,
with the UNGM map's amplification over 20 steps), and the two simulators'
sample statistics agree within five standard errors.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssmtoybox_tpu import ssmod as jssmod
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
from ssmtoybox_torch import convert, ssmod
from ssmtoybox_torch.utils import GaussRV
from ssmtoybox_torch import set_device


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


REENTRY_MEAN = np.array([6500.4, 349.14, -1.8093, -6.7967, 0.6932])
REENTRY_COV = np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0])
REENTRY_Q = np.diag([2.4064e-5, 2.4064e-5, 1e-6])
RADAR_R = np.diag([1e-3, 1e-5])
RADAR_LOC = np.array([6374.0, 0.0])


def _models():
    """(port, JAX) pairs of the study's four models."""
    return {
        "ungm": (ssmod.UNGMTransition(GaussRV(1, cov=5.0), GaussRV(1, cov=10.0)),
                 jssmod.UNGMTransition.create(JGaussRV.create(1, cov=5.0),
                                              JGaussRV.create(1, cov=10.0))),
        "ungm_obs": (ssmod.UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1),
                     jssmod.UNGMMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1)),
        "reentry": (ssmod.ReentryVehicle2DTransition(
                        GaussRV(5, mean=REENTRY_MEAN, cov=REENTRY_COV), GaussRV(3, cov=REENTRY_Q),
                        dt=0.05),
                    jssmod.ReentryVehicle2DTransition.create(
                        JGaussRV.create(5, mean=REENTRY_MEAN, cov=REENTRY_COV),
                        JGaussRV.create(3, cov=REENTRY_Q), dt=0.05)),
        "radar": (ssmod.Radar2DMeasurement(GaussRV(2, cov=RADAR_R), dim_state=5,
                                           state_index=[0, 1], radar_loc=RADAR_LOC),
                  jssmod.Radar2DMeasurement.create(JGaussRV.create(2, cov=RADAR_R), dim_state=5,
                                                   state_index=[0, 1], radar_loc=RADAR_LOC)),
    }


def _states(rng, name, n):
    if name.startswith("ungm"):
        return rng.normal(scale=5.0, size=(n, 1))
    return REENTRY_MEAN + rng.normal(size=(n, 5)) * np.array([1.0, 1.0, 0.1, 0.1, 0.3])


@pytest.mark.parametrize("name", ["ungm", "ungm_obs", "reentry", "radar"])
def test_model_functions_match_jax(name):
    tm, jm = _models()[name]
    rng = np.random.default_rng(4)
    x = _states(rng, name, 16)
    noise = rng.normal(size=(16, tm.dim_noise))
    if name in ("ungm", "reentry"):
        got = tm.dyn_fcn(torch.as_tensor(x), torch.as_tensor(noise), 3)
        ref = jax.vmap(jm.dyn_fcn, in_axes=(0, 0, None))(jnp.asarray(x), jnp.asarray(noise), 3)
        got_eval = tm.dyn_eval(torch.as_tensor(x), 3)
        ref_eval = jax.vmap(jm.dyn_eval, in_axes=(0, None))(jnp.asarray(x), 3)
    else:
        sub = x[:, list(jm.state_index)] if jm.state_index else x
        got = tm.meas_fcn(torch.as_tensor(sub), torch.as_tensor(noise), 3)
        ref = jax.vmap(jm.meas_fcn, in_axes=(0, 0, None))(jnp.asarray(sub), jnp.asarray(noise), 3)
        got_eval = tm.meas_eval(torch.as_tensor(x), 3)
        ref_eval = jax.vmap(jm.meas_eval, in_axes=(0, None))(jnp.asarray(x), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(ref_eval), rtol=1e-13, atol=1e-13)
    assert tm.dim_in == jm.dim_in


@pytest.mark.parametrize("dyn_name,obs_name", [("ungm", "ungm_obs"), ("reentry", "radar")])
def test_simulators_replayed_through_jax_models(dyn_name, obs_name):
    """The port's simulated trajectories equal the JAX model recursion fed
    the same draws, with the JAX package's time stamps (state step k -> k+1
    at time k, measurement index k at time k+1)."""
    models = _models()
    (td, jd), (to, jo) = models[dyn_name], models[obs_name]
    steps, mc = 20, 6
    x = td.simulate_discrete(torch.Generator().manual_seed(7), steps, mc)
    y = to.simulate_measurements(torch.Generator().manual_seed(8), x)
    assert tuple(x.shape) == (td.dim_state, steps, mc)
    assert tuple(y.shape) == (to.dim_out, steps, mc)

    gen = torch.Generator().manual_seed(7)
    x0 = td.init_rv.sample(gen, (mc,)).numpy()                       # (D, M)
    q = td.noise_rv.sample(gen, (steps, mc)).numpy()                 # (Dq, steps, M)
    dyn = jax.vmap(jd.dyn_fcn, in_axes=(1, 1, None), out_axes=1)
    ref = [jnp.asarray(x0)]
    for k in range(steps - 1):
        ref.append(dyn(ref[-1], jnp.asarray(q[:, k]), k))
    ref = np.stack([np.asarray(r) for r in ref], axis=1)
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-9, atol=1e-9)

    r = to.noise_rv.sample(torch.Generator().manual_seed(8), (steps, mc)).numpy()
    xs = x.numpy()[list(jo.state_index)] if jo.state_index else x.numpy()
    meas = jax.vmap(jo.meas_fcn, in_axes=(1, 1, None), out_axes=1)
    y_ref = np.stack([np.asarray(meas(jnp.asarray(xs[:, k]), jnp.asarray(r[:, k]), k + 1))
                      for k in range(steps)], axis=1)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-12, atol=1e-12)


def test_ungm_simulator_statistics_match_jax():
    """Mean and standard deviation of the state at several times agree with
    the JAX simulator's within five standard errors (4000 draws each)."""
    (td, jd), (to, jo) = _models()["ungm"], _models()["ungm_obs"]
    mc, steps = 4000, 6
    x = td.simulate_discrete(torch.Generator().manual_seed(1), steps, mc).numpy()[0]
    y = to.simulate_measurements(torch.Generator().manual_seed(2),
                                 torch.as_tensor(x[None])).numpy()[0]
    xj = np.asarray(jd.simulate_discrete(jax.random.PRNGKey(1), steps, mc))[0]
    yj = np.asarray(jo.simulate_measurements(jax.random.PRNGKey(2), xj[None]))[0]
    for a, b in ((x, xj), (y, yj)):
        for k in range(steps):
            se = np.sqrt((a[k].var() + b[k].var()) / mc)
            assert abs(a[k].mean() - b[k].mean()) < 5 * se, k
            se_sd = np.sqrt((a[k].var() + b[k].var()) / (2 * mc))
            assert abs(a[k].std() - b[k].std()) < 5 * se_sd, k


def test_gauss_rv_sample_statistics():
    rv = GaussRV(2, mean=[1.0, -2.0], cov=[[2.0, 0.6], [0.6, 1.0]])
    s = rv.sample(torch.Generator().manual_seed(0), (20000,)).numpy()
    assert s.shape == (2, 20000)
    np.testing.assert_allclose(s.mean(axis=1), [1.0, -2.0], atol=0.05)
    np.testing.assert_allclose(np.cov(s), [[2.0, 0.6], [0.6, 1.0]], atol=0.06)


def _model_arrays(jm):
    d = {"noise_mean": np.asarray(jm.noise_rv.mean), "noise_cov": np.asarray(jm.noise_rv.cov)}
    if hasattr(jm, "init_rv"):
        d.update(init_mean=np.asarray(jm.init_rv.mean), init_cov=np.asarray(jm.init_rv.cov),
                 noise_gain=np.asarray(jm.noise_gain))
        if hasattr(jm, "dt"):
            d["dt"] = jm.dt
    else:
        d.update(dim_state=jm.dim_state, state_index=jm.state_index)
        if hasattr(jm, "radar_loc"):
            d["radar_loc"] = np.asarray(jm.radar_loc)
    return d


@pytest.mark.parametrize("name,kind", [
    ("ungm", "UNGMTransition"), ("ungm_obs", "UNGMMeasurement"),
    ("reentry", "ReentryVehicle2DTransition"), ("radar", "Radar2DMeasurement")])
def test_model_carried_from_jax(name, kind):
    tm, jm = _models()[name]
    loaded = convert.model_from_numpy(kind, _model_arrays(jm))
    assert type(loaded) is type(tm)
    for a, b in zip(loaded.noise_rv.get_stats(), tm.noise_rv.get_stats()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    x = torch.as_tensor(_states(np.random.default_rng(0), name, 8))
    f = "dyn_eval" if hasattr(tm, "init_rv") else "meas_eval"
    torch.testing.assert_close(getattr(loaded, f)(x, 2), getattr(tm, f)(x, 2), rtol=0, atol=0)


def test_unknown_model_kind_raises():
    with pytest.raises(ValueError, match="unknown model"):
        convert.model_from_numpy("NoSuchTransition", {})
