"""The time axis split over a mesh of ranks in the PyTorch port
(``ssmtoybox_torch/parallel/shardtime.py``): the sharded associative scan
against the JAX package's ``ssmtoybox_tpu/parallel/shardtime.py``, the
sharded affine passes and ``iterated_parallel_smoother(mesh=)`` against the
port's unsharded calls (which ``test_torch_timescan.py``,
``test_torch_sqrttime.py`` and ``test_torch_iplf.py`` hold to the JAX
package).

Ranks run as threads of this process, each with its own gloo group over one
in-memory store (``parallel.mesh.thread_ranks``); every rank's result is
checked.  The JAX scans run on 2- and 4-device ``("t",)`` meshes of the
virtual CPU devices, one ``jax.jit`` compile a mesh.  Tolerances, relative
to each stream's largest entry: the scans of matrix products 1e-12; the
affine passes and the iterated smoother 1e-10.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from ssmtoybox_tpu.parallel.shardtime import sharded_associative_scan as jsharded_scan
from ssmtoybox_torch import mtran, parallel as par, set_device, ssmod
from ssmtoybox_torch.parallel.mesh import Mesh, thread_ranks
from ssmtoybox_torch.utils import GaussRV

SCAN_TOL = 1e-12
TOL = 1e-10
DT = 0.01
Q = 0.1 * np.array([[DT ** 3 / 3, DT ** 2 / 2], [DT ** 2 / 2, DT]])


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
    """``work(mesh)`` on a ``("t",)`` mesh of ``size`` thread ranks."""
    return thread_ranks(lambda group: work(Mesh({"t": size}, group)), size)


SCAN_CASES = [(n_dev, n, rev) for n_dev in (2, 4) for n in (32, 30) for rev in (False, True)]


def _mats(n):
    """Non-commutative 2 x 2 factors: the order of each combine shows."""
    return 0.4 * np.random.default_rng(n).normal(size=(n, 2, 2)) + np.eye(2)


@functools.lru_cache(maxsize=None)
def _jax_scans(n_dev):
    """The JAX package's sharded scans on a mesh of ``n_dev`` devices, one
    compile (a program spans one mesh)."""
    fn = lambda agg, el: jnp.einsum("...ij,...jk->...ik", agg, el)
    mesh = JMesh(np.asarray(jax.devices()[:n_dev]), axis_names=("t",))

    @jax.jit
    def run(m32, m30):
        mats = {32: m32, 30: m30}
        return {(n, rev): jsharded_scan(fn, mats[n], mesh, "t", reverse=rev,
                                        identity=jnp.eye(2))
                for k, n, rev in SCAN_CASES if k == n_dev}

    return run(jnp.asarray(_mats(32)), jnp.asarray(_mats(30)))


@pytest.mark.parametrize("n_dev, n, reverse", SCAN_CASES)
def test_sharded_scan_matches_jax(n_dev, n, reverse):
    """32 steps divide by both axes; 30 steps on 4 ranks pad with the
    identity."""
    want = _jax_scans(n_dev)[n, reverse]
    mats = torch.from_numpy(_mats(n))
    fn = lambda a, b: (a[0] @ b[0],)
    outs = _on_ranks(n_dev, lambda mesh: par.sharded_associative_scan(
        fn, (mats,), mesh, "t", reverse=reverse, identity=(torch.eye(2, dtype=torch.float64),)))
    for rank, (got,) in enumerate(outs):
        assert got.shape == (n, 2, 2)
        _close(got, want, SCAN_TOL, f"rank {rank}")


def test_indivisible_without_identity_raises():
    mats = torch.eye(2, dtype=torch.float64).expand(31, 2, 2)
    with pytest.raises(ValueError, match="does not divide"):
        _on_ranks(2, lambda mesh: par.sharded_associative_scan(
            lambda a, b: (a[0] @ b[0],), (mats,), mesh, "t"))


def _affine(n, d=3, e=2, seed=5):
    """A random stable time-varying affine model and its record."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64))

    def pd(*lead, k):
        a = rng.normal(size=lead + (k, k))
        return a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(k)

    A = rng.normal(size=(n, d, d))
    Fs = 0.9 * A / np.linalg.norm(A, axis=(1, 2))[:, None, None]
    Qs, Rs, P0 = 0.2 * pd(n, k=d), 0.5 * pd(n, k=e), pd(k=d)
    full = tuple(t(a) for a in (Fs, 0.1 * rng.normal(size=(n, d)), Qs, rng.normal(size=(n, e, d)),
                                0.1 * rng.normal(size=(n, e)), Rs, rng.normal(size=d), P0,
                                rng.normal(size=(e, n))))
    chol = lambda a: torch.linalg.cholesky(a)
    sqrt = full[:2] + (chol(full[2]),) + full[3:5] + (chol(full[5]), full[6], chol(full[7]),
                                                      full[8])
    return full, sqrt


def _affine_passes(full, sqrt, mesh=None):
    """Filter and smoother in both forms: eight streams."""
    Fs, bs, Qs, SQs = full[0], full[1], full[2], sqrt[2]
    if mesh is None:
        fm, fP = par.parallel_affine_filter(*full)
        qm, qS = par.parallel_affine_sqrt_filter(*sqrt)
        return (fm, fP) + par.parallel_affine_smoother(Fs, bs, Qs, fm, fP) + (qm, qS) \
            + par.parallel_affine_sqrt_smoother(Fs, bs, SQs, qm, qS)
    fm, fP = par.sharded_parallel_affine_filter(*full, mesh)
    qm, qS = par.sharded_parallel_affine_sqrt_filter(*sqrt, mesh)
    return (fm, fP) + par.sharded_parallel_affine_smoother(Fs, bs, Qs, fm, fP, mesh) + (qm, qS) \
        + par.sharded_parallel_affine_sqrt_smoother(Fs, bs, SQs, qm, qS, mesh)


@pytest.mark.parametrize("size, n", [(2, 30), (4, 30), (4, 5)])
def test_sharded_affine_passes_match_unsharded(size, n):
    """30 steps on 4 ranks pad 2 identities; 5 on 4 leave the last rank
    nothing but padding and the one before a single step."""
    full, sqrt = _affine(n)
    want = _affine_passes(full, sqrt)
    for rank, got in enumerate(_on_ranks(size, lambda mesh: _affine_passes(full, sqrt, mesh))):
        for k, (g, w) in enumerate(zip(got, want)):
            _close(g, w, TOL, f"rank {rank}, stream {k}")


def _pendulum_record(steps=30):
    dyn = ssmod.Pendulum2DTransition(GaussRV(2, mean=[1.5, 0.0], cov=0.01 * np.eye(2)),
                                     GaussRV(2, cov=Q), dt=DT)
    obs = ssmod.Pendulum2DMeasurement(GaussRV(1, cov=0.1), dim_state=2)
    gen = torch.Generator().manual_seed(1)
    x = dyn.simulate_discrete(gen, steps=steps, mc_sims=1)
    return dyn, obs, obs.simulate_measurements(gen, x)[..., 0]


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("sqrt", [False, True])
def test_iterated_smoother_on_a_mesh_matches_unsharded(size, sqrt):
    dyn, obs, y = _pendulum_record()
    ut = mtran.UnscentedTransform(2)
    want = par.iterated_parallel_smoother(dyn, obs, ut, ut, y, iterations=2, sqrt=sqrt)

    def work(mesh):
        res = par.iterated_parallel_smoother(dyn, obs, ut, ut, y, iterations=2, sqrt=sqrt,
                                             mesh=mesh, mesh_axis="t")
        return res, dict(mesh.stats)

    for rank, (got, stats) in enumerate(_on_ranks(size, work)):
        for f in ("fi_mean", "fi_cov", "sm_mean", "sm_cov"):
            _close(getattr(got, f), getattr(want, f), TOL, f"rank {rank} {f}")
        # two passes an iteration, two gathers a pass
        assert stats["all_gather"] == 2 * 2 * 2 and stats["all_reduce"] == 0


def test_mesh_with_scan_block_len_raises():
    dyn, obs, y = _pendulum_record(16)
    ut = mtran.UnscentedTransform(2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        par.iterated_parallel_smoother(dyn, obs, ut, ut, y, sqrt=True, scan_block_len=8,
                                       mesh=Mesh({"t": 1}))


def test_world_of_one_rank_through_real_gloo_groups():
    """A gloo group of one rank built directly on a ``HashStore``, and the
    default group initialised on one: the collectives run and the results
    are the unsharded ones to rounding.  Without a group the mesh says that
    it is a world of one."""
    dist = torch.distributed
    full, sqrt = _affine(12)
    want = _affine_passes(full, sqrt)
    direct = Mesh({"t": 1}, dist.ProcessGroupGloo(dist.HashStore(), 0, 1))
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        default = Mesh({"t": 1})          # no group given: the default one
        assert default.backend == "gloo" and default.group is not None
        for mesh in (direct, default):
            for k, (g, w) in enumerate(zip(_affine_passes(full, sqrt, mesh), want)):
                _close(g, w, TOL, f"{mesh}, stream {k}")
            assert mesh.stats["all_gather"] == 8
    finally:
        dist.destroy_process_group()
    assert "a world of one rank" in repr(Mesh({"t": 1}))
