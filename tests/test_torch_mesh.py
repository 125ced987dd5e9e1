"""Monte-Carlo studies and fits over a mesh of ranks in the PyTorch port
(``ssmtoybox_torch/parallel/mesh.py`` and ``parallel/fit.py``).

``filter_mc_sharded`` is held to the JAX package's on a ``make_mesh(dp=4)``
of the virtual CPU devices (one compile); the bank, the metrics and the fit
to the port's unsharded calls.  Ranks run as threads of this process, each
with its own gloo group over one in-memory store; every rank's result is
checked.  Tolerances, relative to each stream's largest entry: against the
JAX package 1e-9; against the port's unsharded calls 1e-12, the fit's 20
Adam steps 1e-9.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu import parallel as jpar
from ssmtoybox_tpu.ssmod import UNGMMeasurement as JUNGMMeasurement
from ssmtoybox_tpu.ssmod import UNGMTransition as JUNGMTransition
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import parallel as par, set_device
from ssmtoybox_torch.bq.models import GaussianProcessModel
from ssmtoybox_torch.bq.transforms import GaussianProcessTransform
from ssmtoybox_torch.parallel.mesh import multihost_layout, thread_ranks
from ssmtoybox_torch.ssmod import UNGMMeasurement, UNGMTransition
from ssmtoybox_torch.utils import GaussRV

JAX_TOL = 1e-9
TOL = 1e-12
ADAM_TOL = 1e-9
FIELDS = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")


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
    a, b = _np(a), _np(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-300),
                               err_msg=label)


def _on_ranks(size, work):
    """``work(group)`` on ``size`` thread ranks; a world of one rank (no
    group) for ``size == 1``."""
    return thread_ranks(work, size) if size > 1 else [work(None)]


@functools.lru_cache(maxsize=None)
def _study():
    """The UNGM models of both packages, 12 trajectories of 30 steps
    simulated by the port and the port's UKF transforms."""
    dyn = UNGMTransition(GaussRV(1, cov=5.0), GaussRV(1, cov=10.0))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1)
    gen = torch.Generator().manual_seed(0)
    x = dyn.simulate_discrete(gen, steps=30, mc_sims=12)
    xs, ys = x.permute(2, 0, 1), obs.simulate_measurements(gen, x).permute(2, 0, 1)
    ukf = stt.UnscentedKalman(dyn, obs)
    return dyn, obs, ukf.tf_dyn, ukf.tf_obs, xs, ys


@functools.lru_cache(maxsize=None)
def _jax_sharded():
    """The JAX package's ``filter_mc_sharded`` of the study on a
    ``make_mesh(dp=4)``."""
    *_, ys = _study()
    jdyn = JUNGMTransition.create(JGaussRV.create(1, cov=5.0), JGaussRV.create(1, cov=10.0))
    jobs = JUNGMMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1)
    ukf = st.UnscentedKalman(jdyn, jobs)
    return jpar.filter_mc_sharded(jdyn, jobs, ukf.tf_dyn, ukf.tf_obs, jnp.asarray(_np(ys)),
                                  jpar.make_mesh(dp=4))


@pytest.mark.parametrize("dp", [2, 3])
def test_filter_mc_sharded_matches_jax(dp):
    """12 rows split over 2 and 3 ranks: every rank holds the whole result."""
    dyn, obs, td, to, _, ys = _study()
    want = _jax_sharded()
    outs = _on_ranks(dp, lambda g: par.filter_mc_sharded(dyn, obs, td, to, ys,
                                                         par.make_mesh(dp=dp, group=g)))
    for rank, got in enumerate(outs):
        for f in FIELDS:
            _close(getattr(got, f), getattr(want, f), JAX_TOL, f"rank {rank} {f}")


@pytest.mark.parametrize("dp", [1, 5])
def test_padding_and_presharded_rows_match_unsharded(dp):
    """12 rows over 5 ranks pad 3 copies of the last row; the rows of
    ``shard_mc`` / ``shard_mc_local`` are filtered as they are."""
    dyn, obs, td, to, xs, ys = _study()
    want = stt.gaussian_filter_batch(dyn, obs, td, to, ys)

    def work(g):
        mesh = par.make_mesh(dp=dp, group=g)
        padded = par.filter_mc_sharded(dyn, obs, td, to, ys, mesh)
        rows = par.shard_mc(ys[:10], mesh)
        local = par.shard_mc_local(rows.rows.clone(), mesh)
        return padded, par.filter_mc_sharded(dyn, obs, td, to, local, mesh)

    for padded, pre in _on_ranks(dp, work):
        for f in FIELDS:
            _close(getattr(padded, f), getattr(want, f), TOL, f)
            _close(getattr(pre, f), getattr(want, f)[:10], TOL, f)


def test_filter_bank_sharded():
    """Four GPQ transforms (lengthscale 1.5, 3, 6, 12) on a (2, 2) mesh and
    three on a (1, 2) mesh (the bank padded): each member its own
    unsharded run."""
    dyn, obs, _, _, _, ys = _study()
    bank = [GaussianProcessTransform(1, 1, np.array([[1.0, 3.0 * s]]), point_str="ut")
            for s in (0.5, 1.0, 2.0, 4.0)]
    want = [stt.gaussian_filter_batch(dyn, obs, t, t, ys) for t in bank]
    for (dp, fb), k in (((2, 2), 4), ((1, 2), 3)):
        outs = _on_ranks(dp * fb, lambda g: par.filter_bank_sharded(
            dyn, obs, bank[:k], bank[:k], ys, par.make_mesh(dp=dp, fb=fb, group=g)))
        for got in outs:
            assert tuple(got.fi_mean.shape) == (k, 12, 1, 30)
            for j in range(k):
                for f in FIELDS:
                    _close(getattr(got, f)[j], getattr(want[j], f), TOL, f"member {j} {f}")


def test_mc_metrics_sharded_and_its_guard():
    dyn, obs, td, to, xs, ys = _study()
    res = stt.gaussian_filter_batch(dyn, obs, td, to, ys)
    want = torch.sqrt(torch.mean(torch.sum((xs - res.fi_mean) ** 2, dim=1), dim=1)).mean()

    def work(g):
        mesh = par.make_mesh(dp=5, group=g)
        got = par.mc_metrics_sharded(xs, res, mesh)
        local = par.mc_metrics_sharded(par.shard_mc(xs[:10], mesh),
                                       par.filter_mc_sharded(dyn, obs, td, to, ys[:10], mesh),
                                       mesh)
        with pytest.raises(ValueError, match="must match"):
            bank_like = type(res)(**{f: getattr(res, f)[None] for f in FIELDS})
            par.mc_metrics_sharded(xs, bank_like, mesh)
        return got, local, mesh.stats["all_reduce"]

    want10 = torch.sqrt(torch.mean(torch.sum((xs - res.fi_mean)[:10] ** 2, dim=1), dim=1)).mean()
    for got, local, reduces in thread_ranks(work, 5):
        _close(got, want, TOL)
        _close(local, want10, TOL)
        assert reduces == 2


def test_make_mesh_guards():
    with pytest.raises(ValueError, match="devices"):
        par.make_mesh(fb=16)                       # one rank: dp = 0
    with pytest.raises(ValueError, match="devices"):
        par.make_mesh(dp=2)                        # never a stand-in for a larger world
    mesh = par.make_mesh()
    assert mesh.shape == {"dp": 1, "fb": 1} and "a world of one rank" in repr(mesh)
    shapes = thread_ranks(lambda g: par.make_mesh(dp=2, fb=2, group=g).shape, 4)
    assert shapes == [{"dp": 2, "fb": 2}] * 4


def test_multihost_geometry_and_refusals():
    """The host-major layout as ``tests/test_parallel.py`` holds it for the
    JAX package: 2 hosts of 4 ranks, ``fb`` within a host."""
    grid = multihost_layout([0] * 8, fb=1, process_shape=(2, 4))
    assert grid.shape == (8, 1) and grid[:4, 0].tolist() == [0, 1, 2, 3]
    assert multihost_layout([0] * 8, fb=2, process_shape=(2, 4)).shape == (4, 2)
    # ranks of interleaved hosts: host-major rows, an fb slice within a host
    grid = multihost_layout(["a", "b"] * 4, fb=2)
    assert grid.tolist() == [[0, 2], [4, 6], [1, 3], [5, 7]]
    with pytest.raises(ValueError, match="straddling"):
        multihost_layout([0] * 8, fb=8, process_shape=(2, 4))
    with pytest.raises(ValueError, match="tile"):
        multihost_layout([0] * 8, process_shape=(3, 3))
    with pytest.raises(ValueError, match="homogeneous"):
        multihost_layout(["a", "a", "b"])

    def work(g):
        mesh = par.make_multihost_mesh(fb=2, process_shape=(2, 4), group=g)
        with pytest.raises(ValueError, match="straddling"):
            par.make_multihost_mesh(fb=8, process_shape=(2, 4), group=g)
        hosts = par.make_multihost_mesh(group=g)          # one host: the gathered names
        return mesh.shape, mesh.coords, hosts.shape

    outs = thread_ranks(work, 8)
    assert [o[0] for o in outs] == [{"dp": 4, "fb": 2}] * 8
    assert [o[1] for o in outs[:4]] == [{"dp": 0, "fb": 0}, {"dp": 0, "fb": 1},
                                        {"dp": 1, "fb": 0}, {"dp": 1, "fb": 1}]
    assert all(o[2] == {"dp": 8, "fb": 1} for o in outs)


def test_fit_on_three_ranks_matches_unsharded():
    """48 sets over 3 ranks (and 50 over 3: two sets of weight zero pad the
    batch): 20 Adam steps as the unsharded fit, on every rank."""
    dyn, *_ = _study()
    gp = GaussianProcessModel(1, np.array([[1.0, 3.0]]), "rbf", "ut")
    states = torch.from_numpy(np.random.default_rng(2).normal(size=(50, 1, 1)) * 3.0)
    fo = dyn.dyn_eval(states + gp.points.T, torch.arange(50.0, dtype=torch.float64)[:, None, None])
    for b in (48, 50):
        want = par.fit_kernel_params(gp, np.zeros(2), fo[:b], gp.points, num_steps=20)
        outs = thread_ranks(lambda g: par.fit_kernel_params(
            gp, np.zeros(2), fo[:b], gp.points, num_steps=20,
            mesh=par.make_mesh(dp=3, group=g)), 3)
        for lp, losses in outs:
            _close(losses, want[1], ADAM_TOL, f"{b} sets: losses")
            _close(lp, want[0], ADAM_TOL, f"{b} sets: log-parameters")


def test_thread_ranks_report_a_failed_or_late_rank():
    """The rank that fails first is reported, though its peer is left
    waiting in a collective (until the groups' timeout); a rank that does not
    end in time raises ``TimeoutError``."""
    import time

    def one_fails(g):
        mesh = par.make_mesh(dp=2, group=g)
        if mesh.rank == 1:
            raise RuntimeError("rank 1 failed")
        return mesh.all_gather([torch.zeros(1)])

    with pytest.raises(RuntimeError, match="rank 1 failed"):
        thread_ranks(one_fails, 2, timeout=2.0)
    with pytest.raises(TimeoutError, match=r"ranks \[1\]"):
        thread_ranks(lambda g: time.sleep(3.0 * g.rank()), 2, timeout=1.0)
