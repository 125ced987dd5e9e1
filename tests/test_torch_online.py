"""Streaming filtering, fixed-lag smoothing, checkpoints and profiling helpers
in the PyTorch port (``tests/test_online.py`` on the port).

Tolerances: the online filter against the port's own batch filter and the
fixed-lag smoother against its own offline RTS at 1e-12 (the same
operations, step by step); the online filter against the JAX package's on
20 steps at 1e-10.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssmtoybox_tpu.online import make_online_filter as jax_make_online_filter
from ssmtoybox_tpu.ssmod import UNGMMeasurement as JUNGMMeasurement
from ssmtoybox_tpu.ssmod import UNGMTransition as JUNGMTransition
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
import ssmtoybox_tpu as st
import ssmtoybox_torch as stt
from ssmtoybox_torch import set_device
from ssmtoybox_torch.online import (FixedLagState, OnlineState, make_fixed_lag_smoother,
                                    make_online_filter)
from ssmtoybox_torch.ssinf import _gaussian_time_update
from ssmtoybox_torch.ssmod import UNGMMeasurement, UNGMTransition
from ssmtoybox_torch.utils import GaussRV, sync, timeit, trace
from ssmtoybox_torch.utils.checkpoint import restore_pytree, save_pytree


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


def _close(got, want, tol, label=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=label)


def _setup():
    dyn = UNGMTransition(GaussRV(1, cov=5.0), GaussRV(1, cov=10.0))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1)
    return dyn, obs, stt.UnscentedKalman(dyn, obs)


def _record(dyn, obs, steps, runs=1, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = dyn.simulate_discrete(gen, steps=steps, mc_sims=runs)
    return x, obs.simulate_measurements(gen, x)                  # (1, steps, runs)


@pytest.mark.parametrize("donate", [False, True])
def test_online_matches_batch_forward(donate):
    dyn, obs, ukf = _setup()
    _, y = _record(dyn, obs, 25)
    fm, fP = ukf.forward_pass(y[..., 0])
    init, step = make_online_filter(dyn, obs, ukf.tf_dyn, ukf.tf_obs, donate=donate)
    state = init()
    means, covs = [], []
    for k in range(y.shape[1]):
        state, info = step(state, y[:, k, 0])
        means.append(state.mean.clone())
        covs.append(state.cov.clone())
    _close(torch.stack(means, -1), fm, 1e-12, "mean")
    _close(torch.stack(covs, -1), fP, 1e-12, "cov")
    assert int(state.step) == 26


def test_online_matches_jax_online_filter():
    dyn, obs, ukf = _setup()
    _, y = _record(dyn, obs, 20, seed=3)
    jd = JUNGMTransition.create(JGaussRV.create(1, cov=5.0), JGaussRV.create(1, cov=10.0))
    jo = JUNGMMeasurement.create(JGaussRV.create(1), dim_state=1)
    jukf = st.UnscentedKalman(jd, jo)
    jinit, jstep = jax_make_online_filter(jd, jo, jukf.tf_dyn, jukf.tf_obs, donate=False)
    init, step = make_online_filter(dyn, obs, ukf.tf_dyn, ukf.tf_obs)
    state, jstate = init(), jinit()
    for k in range(y.shape[1]):
        state, info = step(state, y[:, k, 0])
        jstate, jinfo = jstep(jstate, jnp.asarray(y[:, k, 0].numpy()))
        _close(state.mean, jstate.mean, 1e-10, f"mean, step {k + 1}")
        _close(state.cov, jstate.cov, 1e-10, f"cov, step {k + 1}")
        _close(info.innov, jinfo.innov, 1e-10, f"innovation, step {k + 1}")


def test_online_dropout_keeps_prediction():
    dyn, obs, ukf = _setup()
    init, step = make_online_filter(dyn, obs, ukf.tf_dyn, ukf.tf_obs, donate=False)
    state = init()
    s1, _ = step(state, torch.tensor([2.0], dtype=torch.float64), observed=False)
    m_pr, P_pr, *_ = _gaussian_time_update(dyn, obs, ukf.tf_dyn, ukf.tf_obs,
                                           state.mean[None], state.cov[None], 0)
    _close(s1.mean, m_pr[0], 1e-12)
    _close(s1.cov, P_pr[0], 1e-12)


def test_online_batched_multi_target():
    """Six targets in one step, the third without a measurement: each row is
    the unbatched filter's step on that target."""
    dyn, obs, ukf = _setup()
    init, step = make_online_filter(dyn, obs, ukf.tf_dyn, ukf.tf_obs, batch=True)
    state = init(batch_size=6)
    ys = torch.tensor(np.random.RandomState(0).randn(6, 1))
    observed = torch.tensor([True, True, False, True, True, True])
    state, info = step(state, ys, observed=observed)
    assert state.mean.shape == (6, 1) and state.cov.shape == (6, 1, 1)
    assert info.innov.shape == (6, 1) and state.step.shape == (6,)
    one_init, one_step = make_online_filter(dyn, obs, ukf.tf_dyn, ukf.tf_obs)
    for i in range(6):
        s, _ = one_step(one_init(), ys[i], observed=bool(observed[i]))
        _close(state.mean[i], s.mean, 1e-12, f"target {i}")
        _close(state.cov[i], s.cov, 1e-12, f"target {i}")


def test_online_batch_matches_gaussian_filter_batch():
    dyn, obs, ukf = _setup()
    _, y = _record(dyn, obs, 25, runs=5, seed=1)
    ref = stt.gaussian_filter_batch(dyn, obs, ukf.tf_dyn, ukf.tf_obs, y.permute(2, 0, 1))
    init, step = make_online_filter(dyn, obs, ukf.tf_dyn, ukf.tf_obs, batch=True)
    state = init(batch_size=5)
    for k in range(y.shape[1]):
        state, _ = step(state, y[:, k].T)
    _close(state.mean, ref.fi_mean[..., -1], 1e-12)
    _close(state.cov, ref.fi_cov[..., -1], 1e-12)


def test_online_donation_does_not_eat_the_prior():
    """``init()`` copies the prior: a donated step writes into the state's
    own tensors, never into the model's."""
    dyn, obs, ukf = _setup()
    init, step = make_online_filter(dyn, obs, ukf.tf_dyn, ukf.tf_obs)      # donate=True
    state = init()
    mean_t = state.mean
    state, _ = step(state, torch.tensor([1.0], dtype=torch.float64))
    state, _ = step(state, torch.tensor([0.2], dtype=torch.float64))
    assert state.mean is mean_t                                # written in place
    assert float(dyn.init_rv.mean) == 0.0 and float(dyn.init_rv.cov) == 5.0
    state2, _ = step(init(), torch.tensor([1.0], dtype=torch.float64))
    assert bool(torch.isfinite(state2.mean).all()) and int(state2.step) == 2


def test_init_batch_size_guards():
    dyn, obs, ukf = _setup()
    init, _ = make_online_filter(dyn, obs, ukf.tf_dyn, ukf.tf_obs, batch=False)
    with pytest.raises(ValueError, match="batch=True"):
        init(batch_size=4)
    init, _ = make_online_filter(dyn, obs, ukf.tf_dyn, ukf.tf_obs, batch=True)
    with pytest.raises(ValueError, match="batch_size"):
        init()


@pytest.mark.parametrize("donate", [False, True])
def test_fixed_lag_smoother_matches_offline_rts(donate):
    """At each step n >= lag the emitted estimate of x_{n-lag+1} given y_{1:n}
    is the offline RTS (``rts_full=True``) of the record cut at n."""
    dyn, obs, ukf = _setup()
    lag, steps = 5, 14
    _, y = _record(dyn, obs, steps, seed=4)
    init, step = make_fixed_lag_smoother(dyn, obs, ukf.tf_dyn, ukf.tf_obs, lag=lag,
                                         donate=donate)
    state = init()
    for n in range(1, steps + 1):
        state, info, (sm_m, sm_P) = step(state, y[:, n - 1, 0])
        if n >= lag:
            res = stt.gaussian_filter(dyn, obs, ukf.tf_dyn, ukf.tf_obs, y[:, :n, 0])
            sm_all, sP_all = stt.gaussian_smoother(res, rts_full=True)
            _close(sm_m, sm_all[:, n - lag], 1e-10, f"n={n}")
            _close(sm_P, sP_all[:, :, n - lag], 1e-10, f"n={n}")


def test_fixed_lag_smoother_batched_and_guards():
    dyn, obs, ukf = _setup()
    with pytest.raises(ValueError, match="lag >= 2"):
        make_fixed_lag_smoother(dyn, obs, ukf.tf_dyn, ukf.tf_obs, lag=1)
    init, step = make_fixed_lag_smoother(dyn, obs, ukf.tf_dyn, ukf.tf_obs, lag=3, batch=True)
    with pytest.raises(ValueError, match="batch_size"):
        init()
    state = init(batch_size=4)
    assert isinstance(state, FixedLagState) and state.buf_fi_m.shape == (4, 3, 1)
    y = torch.ones(4, 1, dtype=torch.float64)
    for _ in range(6):
        state, info, (sm_m, sm_P) = step(state, y)
    assert sm_m.shape == (4, 1) and sm_P.shape == (4, 1, 1)
    assert bool(torch.isfinite(sm_m).all())


def test_checkpoint_roundtrip_and_resume(tmp_path):
    dyn, obs, ukf = _setup()
    init, step = make_online_filter(dyn, obs, ukf.tf_dyn, ukf.tf_obs, donate=False)
    state, _ = step(init(), torch.tensor([1.0], dtype=torch.float64))
    path = str(tmp_path / "ckpt")
    save_pytree(path, state)
    plain = restore_pytree(path)
    assert isinstance(plain, dict) and set(plain) == {"mean", "cov", "step"}
    restored = restore_pytree(path, like=state)
    assert isinstance(restored, OnlineState)
    for f in ("mean", "cov", "step"):
        a, b = getattr(restored, f), getattr(state, f)
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    s_a, _ = step(state, torch.tensor([0.5], dtype=torch.float64))
    s_b, _ = step(restored, torch.tensor([0.5], dtype=torch.float64))
    assert torch.equal(s_a.mean, s_b.mean) and torch.equal(s_a.cov, s_b.cov)


def test_checkpoint_refuses_silent_overwrite(tmp_path):
    tree = {"a": torch.arange(3.0), "b": [torch.ones(2, dtype=torch.float64)]}
    p = str(tmp_path / "ckpt")
    save_pytree(p, tree)
    with pytest.raises(FileExistsError, match="overwrite=True"):
        save_pytree(p, tree)
    save_pytree(p, {"a": torch.arange(3.0) + 1, "b": [torch.zeros(2)]}, overwrite=True)
    out = restore_pytree(p, like=tree)
    np.testing.assert_allclose(out["a"].numpy(), [1.0, 2.0, 3.0])
    assert out["b"][0].dtype == torch.float64


def test_profiler_trace_writes(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d):
        torch.sum(torch.arange(100.0))
    assert os.path.isdir(d) and len(os.listdir(d)) > 0


def test_timeit_returns_the_median():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x * 2}

    secs, out = timeit(fn, torch.ones(3), repeats=3, warmup=2)
    assert len(calls) == 5 and secs >= 0.0
    assert torch.equal(out["y"], 2 * torch.ones(3))
    assert sync(out) == 6.0
