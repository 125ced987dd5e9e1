"""Samplers, fully-symmetric points and the RBF-Student Monte-Carlo kernels'
plain versions of the PyTorch port, against SciPy, the JAX package and the
kernels' per-element header built for the host.

Tolerances: the fused estimators are float32 with float64 cross-chunk sums on
both sides, differing only in the order of summation inside a chunk, so
values hold at 1e-5 relative and gradients at rtol 1e-4 / atol 1e-5 (the
tolerances of ``tests/test_pallas_ops.py``); point sets are exact formulas
(1e-12); sampler checks are Kolmogorov-Smirnov tests at p > 1e-3.
"""
import re
import shutil

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from ssmtoybox_tpu import points as jpts
from ssmtoybox_tpu.ops.pallas_ops import _student_kxy_core, _student_qRQ
from ssmtoybox_torch import points as pts
from ssmtoybox_torch.mtran import FullySymmetricStudentTransform
from ssmtoybox_torch.ops import student_mc as smc
from ssmtoybox_torch.utils import GaussianMixtureRV, StudentRV, rand
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


F32_REL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape_k", [0.4, 2.0, 7.5])
def test_standard_gamma_matches_scipy(shape_k):
    """Marsaglia-Tsang with the generator (and the ``u^(1/k)`` boost below 1)."""
    g = rand.standard_gamma(_gen(1), shape_k, (20_000,))
    assert stats.kstest(g.numpy(), stats.gamma(shape_k).cdf).pvalue > 1e-3
    again = rand.standard_gamma(_gen(1), shape_k, (20_000,))
    torch.testing.assert_close(g, again, atol=0, rtol=0)


@pytest.mark.parametrize("dof", [3.0, 6.0])
def test_multivariate_t_matches_scipy(dof):
    scale = np.array([[2.0, 0.3], [0.3, 0.5]])
    rv = StudentRV(2, mean=[1.0, -2.0], scale=scale, dof=dof)
    s = rv.sample(_gen(2), 40_000).numpy()                            # (2, 40000)
    for d in range(2):
        t = stats.t(dof, loc=rv.mean[d].item(), scale=np.sqrt(scale[d, d]))
        assert stats.kstest(s[d], t.cdf).pvalue > 1e-3
    # variance dof/(dof - 2) of the unit density
    z = rand.multivariate_t(_gen(3), torch.zeros(3), torch.eye(3), 6.0, (200_000,))
    np.testing.assert_allclose(z.var(0).numpy(), 6.0 / 4.0, rtol=0.05)


def test_student_rv_resets_low_dof_and_returns_scale():
    rv = StudentRV(2, scale=np.diag([2.0, 3.0]), dof=1.5)
    mean, scale, dof = rv.get_stats()
    assert dof == 3.0 and tuple(rv.sample(_gen(0), (4, 5)).shape) == (2, 4, 5)
    torch.testing.assert_close(scale, torch.diag(torch.tensor([2.0, 3.0], dtype=torch.float64)))


def test_gauss_mixture_matches_scipy_and_moments():
    rv = GaussianMixtureRV(1, means=(0.0, 3.0), covs=(1.0, 4.0), alphas=(0.7, 0.3))
    s, ci = rand.gauss_mixture(_gen(4), rv.means, rv.covs, rv.alphas, (30_000,))
    cdf = lambda v: 0.7 * stats.norm.cdf(v) + 0.3 * stats.norm.cdf(v, 3.0, 2.0)
    assert stats.kstest(s[:, 0].numpy(), cdf).pvalue > 1e-3
    assert abs(float((ci == 1).double().mean()) - 0.3) < 0.02
    mean, cov = rv.get_stats()
    np.testing.assert_allclose(mean.numpy(), [0.9], atol=1e-12)
    np.testing.assert_allclose(cov.numpy(), [[0.7 + 0.3 * 4.0 + 0.7 * 0.81 + 0.3 * 2.1 ** 2]],
                               atol=1e-12)
    assert tuple(rv.sample(_gen(5), 7).shape) == (1, 7)


# ---------------------------------------------------------------------------
# fully-symmetric Student points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degree", [3, 5])
@pytest.mark.parametrize("dim", [1, 2, 3, 4])
def test_fs_rule_matches_jax(degree, dim):
    for kappa, dof in ((None, 4.0), (0.0, 7.0)):
        np.testing.assert_allclose(pts.fs_points(dim, degree, kappa, dof),
                                   jpts.fs_points(dim, degree, kappa, dof), atol=1e-12)
        np.testing.assert_allclose(pts.fs_weights(dim, degree, kappa, dof),
                                   jpts.fs_weights(dim, degree, kappa, dof), atol=1e-12)
    np.testing.assert_allclose(pts.get_points(dim, "fs", {"degree": degree}),
                               jpts.get_points(dim, "fs", {"degree": degree}), atol=1e-12)
    tf = FullySymmetricStudentTransform(dim, degree)
    np.testing.assert_allclose(tf.unit_sp.numpy(), jpts.fs_points(dim, degree), atol=1e-12)


# ---------------------------------------------------------------------------
# the fused plain versions against the JAX Pallas cores (interpret mode)
# ---------------------------------------------------------------------------

def _fused_case(d, n, chunk, chunks, seed):
    rng = np.random.default_rng(seed)
    samples = (rng.standard_t(4.0, size=(chunk * chunks, d))).astype(np.float32)
    x = rng.normal(size=(d, n))
    par = np.hstack([[1.3], rng.uniform(0.6, 2.5, d)])[None]
    return samples, x, par


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("d,n,chunk,chunks", [(2, 5, 512, 4), (4, 9, 1024, 6)])
def test_qrq_plain_matches_jax_pallas(d, n, chunk, chunks):
    samples, x, par = _fused_case(d, n, chunk, chunks, seed=d)
    weights = [np.random.default_rng(9).normal(size=s) for s in ((n,), (d, n), (n, n))]

    def jax_loss(p, xx):
        out = _student_qRQ(8, 128, chunk, True, p, xx, jnp.asarray(samples))
        return sum(jnp.sum(w * o) for w, o in zip(weights, out)), out

    (_, j_out), j_grad = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(par), jnp.asarray(x))
    p = torch.tensor(par, requires_grad=True)
    xx = torch.tensor(x, requires_grad=True)
    out = smc.student_qrq(p, xx, torch.as_tensor(samples), chunk)
    for a, b in zip(out, j_out):
        assert _rel(a.detach(), b) < F32_REL
    loss = sum(torch.sum(torch.as_tensor(w) * o) for w, o in zip(weights, out))
    for a, b in zip(torch.autograd.grad(loss, (p, xx)), j_grad):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # the plain differentiable version gives the same through autograd
    p2 = torch.tensor(par, requires_grad=True)
    plain = smc.student_qrq_plain(p2, torch.as_tensor(x), torch.as_tensor(samples), chunk)
    for a, b in zip(plain, out):
        torch.testing.assert_close(a, b.detach(), atol=0, rtol=1e-12)


@pytest.mark.parametrize("d,chunk,chunks", [(1, 512, 8), (4, 1024, 4)])
def test_kxy_plain_matches_jax_pallas(d, chunk, chunks):
    samples, _, par = _fused_case(d, 1, chunk, chunks, seed=10 + d)
    core = lambda p: _student_kxy_core(8, chunk, True, p, jnp.asarray(samples))
    j_val, j_grad = jax.value_and_grad(core)(jnp.asarray(par))
    p = torch.tensor(par, requires_grad=True)
    v = smc.student_kxy(p, torch.as_tensor(samples), chunk)
    assert abs(float(v.detach()) - float(j_val)) / abs(float(j_val)) < F32_REL
    (g,) = torch.autograd.grad(v, p)
    np.testing.assert_allclose(g.numpy(), np.asarray(j_grad), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert float(g[0, 0]) == 0.0                  # the scale does not enter
    p2 = torch.tensor(par, requires_grad=True)
    v2 = smc.student_kxy_plain(p2, torch.as_tensor(samples), chunk)
    (g2,) = torch.autograd.grad(v2, p2)
    np.testing.assert_allclose(g2.numpy(), g.numpy(), rtol=GRAD_RTOL, atol=1e-8)


def test_chunking_follows_the_jax_package():
    assert smc.chunking(2_000_000, 4096) == (4096, 488, 488 * 4096)
    assert smc.chunking(2_000_000, 1024) == (1024, 1953, 1953 * 1024)
    assert smc.chunking(1000, 4096) == (1000, 1, 1000)
    assert smc.chunking(3, 1024) == (8, 1, 8)


# ---------------------------------------------------------------------------
# the kernels' per-element header, built for the host
# ---------------------------------------------------------------------------

def test_header_on_host_matches_plain_versions():
    """``csrc/student_mc_rows.cuh`` through ``student_mc_host.cpp`` (g++)
    against the plain versions, per chunk, 1e-5 relative."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the header cannot be built for the host")
    lib = smc._host_shim()
    d, n, chunk, chunks = 3, 7, 300, 3          # a ragged last tile of 64 samples
    samples, x, par = _fused_case(d, n, chunk, chunks, seed=21)
    xs = torch.as_tensor(samples)
    inv_l = (1.0 / torch.as_tensor(par[0, 1:]).float()).contiguous()
    xp = torch.as_tensor(x.T).float().contiguous()
    rng = np.random.default_rng(22)
    gq, gR, gQ = (torch.as_tensor(rng.normal(size=s)).float() for s in ((n,), (d, n), (n, n)))
    gQ2 = (gQ + gQ.T).contiguous()

    out = torch.empty((chunks, n + d * n + n * n))
    lib.smc_host_qrq(inv_l.data_ptr(), xs.data_ptr(), xp.data_ptr(), chunks, chunk, n, d,
                     out.data_ptr())
    assert _rel(out, smc._qrq_partials_plain(inv_l, xs, xp, chunk)) < F32_REL
    out = torch.empty((chunks, n + d * n + d))
    lib.smc_host_qrq_bwd(inv_l.data_ptr(), xs.data_ptr(), xp.data_ptr(), gq.data_ptr(),
                         gR.data_ptr(), gQ2.data_ptr(), chunks, chunk, n, d, out.data_ptr())
    assert _rel(out, smc._qrq_bwd_partials_plain(inv_l, xs, xp, gq, gR, gQ2, chunk)) < F32_REL
    fwd, bwd = _host_kxy(lib, inv_l, xs, chunk)
    assert _rel(fwd, smc._kxy_partials_plain(inv_l, xs, chunk)) < F32_REL
    assert _rel(bwd, smc._kxy_bwd_partials_plain(inv_l, xs, chunk)) < F32_REL


def _qrq_case(d, n, chunk, chunks):
    samples, x, par = _fused_case(d, n, chunk, chunks, seed=70 + 10 * d + n)
    xs = torch.as_tensor(samples)
    inv_l = (1.0 / torch.as_tensor(par[0, 1:]).float()).contiguous()
    xp = torch.as_tensor(x.T).float().contiguous()
    rng = np.random.default_rng(d + n)
    gq, gR, gQ = (torch.as_tensor(rng.normal(size=s)).float() for s in ((n,), (d, n), (n, n)))
    return inv_l, xs, xp, gq, gR, (gQ + gQ.T).contiguous()


# (D, N, chunk, chunks): the study's shape (one chunk of 4,096, the small
# path's bucket at D = 4), a ragged chunk on the small path (300 samples: two
# rounds of 128 threads and a part), fewer points than the bucket (masked),
# the first large shape at D = 4, several large-path tiles and a ragged one
# (1,000 samples in tiles of 384), the FS degree-5 rule (N = 33), points not a
# multiple of 4 (N = 81), the widest shape, and (1, 1)
@pytest.mark.parametrize("d,n,chunk,chunks", [(4, 9, 4096, 1), (3, 7, 300, 3), (4, 5, 300, 2),
                                              (4, 10, 300, 2), (5, 11, 1000, 1),
                                              (4, 33, 1024, 1), (2, 81, 300, 1),
                                              (8, 128, 256, 1), (1, 1, 8, 3)])
def test_header_qrq_walk_matches_plain(d, n, chunk, chunks):
    """The q/R/Q kernels' walk (student_mc_host.cpp replays both paths with
    g++: the small path's threads, masked bucket points, shuffle trees and
    warps in order; the large path's double-buffered tiles, masked padded
    points and samples, micro-tiles and groups) against the plain versions,
    forward and backward, 1e-5."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the header cannot be built for the host")
    lib = smc._host_shim()
    inv_l, xs, xp, gq, gR, gQ2 = _qrq_case(d, n, chunk, chunks)
    out = torch.full((chunks, n + d * n + n * n), float("nan"))
    lib.smc_host_qrq(inv_l.data_ptr(), xs.data_ptr(), xp.data_ptr(), chunks, chunk, n, d,
                     out.data_ptr())
    assert _rel(out, smc._qrq_partials_plain(inv_l, xs, xp, chunk)) < F32_REL
    out = torch.full((chunks, n + d * n + d), float("nan"))
    lib.smc_host_qrq_bwd(inv_l.data_ptr(), xs.data_ptr(), xp.data_ptr(), gq.data_ptr(),
                         gR.data_ptr(), gQ2.data_ptr(), chunks, chunk, n, d, out.data_ptr())
    assert _rel(out, smc._qrq_bwd_partials_plain(inv_l, xs, xp, gq, gR, gQ2, chunk)) < F32_REL


def test_header_qrq_crossover():
    """The small path's point bucket at D is the largest N <= 2 D + 1 (the UT
    and degree-3 FS rules) whose forward keeps at most 132 sums a thread;
    every larger N up to 128 runs on the large path."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the header cannot be built for the host")
    lib = smc._host_shim()
    buckets = {d: lib.smc_host_qrq_bucket(d) for d in range(1, smc.MAX_D + 1)}
    assert buckets == {1: 3, 2: 5, 3: 7, 4: 9, 5: 11, 6: 10, 7: 9, 8: 9}


def _host_kxy(lib, inv_l, xs, chunk):
    """Per-chunk results of the pairwise kernels' tile walk on the host:
    the Gram sums (chunks,) and the gradient partials (chunks, D)."""
    chunks, d = xs.shape[0] // chunk, xs.shape[1]
    fwd, bwd = torch.empty((chunks,)), torch.empty((chunks, d))
    lib.smc_host_kxy(inv_l.data_ptr(), xs.data_ptr(), chunks, chunk, d, 0, fwd.data_ptr())
    lib.smc_host_kxy(inv_l.data_ptr(), xs.data_ptr(), chunks, chunk, d, 1, bwd.data_ptr())
    return fwd, bwd


def _pairwise_case(d, chunk, chunks=3):
    samples, _, par = _fused_case(d, 1, chunk, chunks, seed=50 + 10 * d + chunk % 7)
    return torch.as_tensor(samples), (1.0 / torch.as_tensor(par[0, 1:]).float()).contiguous()


# chunks of a whole number of 64-sample tiles (1024), with a ragged last tile
# (300), below one tile (8) and of one pair (2); one and two planes of four
# components, full (4, 8) and partly filled (1, 3)
@pytest.mark.parametrize("chunk", [2, 8, 300, 1024])
@pytest.mark.parametrize("d", [1, 3, 4, 8])
def test_header_pairwise_walk_matches_plain(d, chunk):
    """The pairwise kernels' walk over the symmetric half of a chunk's Gram
    (masks on the diagonal and the ragged end, the diagonal added as the
    exact chunk size, the gradient from the pairs' differences) against the
    plain versions, which evaluate the whole Gram in the expanded form."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the header cannot be built for the host")
    xs, inv_l = _pairwise_case(d, chunk)
    fwd, bwd = _host_kxy(smc._host_shim(), inv_l, xs, chunk)
    assert _rel(fwd, smc._kxy_partials_plain(inv_l, xs, chunk)) < F32_REL
    assert _rel(bwd, smc._kxy_bwd_partials_plain(inv_l, xs, chunk)) < F32_REL


@pytest.mark.parametrize("d,chunk", [(4, 300), (8, 1024)])
def test_header_pairwise_walk_matches_float64(d, chunk):
    """The same walk against the definition evaluated in float64: the Gram
    sum with its diagonal, and sum_{r<c} k_rc (x_rd - x_cd)^2."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the header cannot be built for the host")
    xs, inv_l = _pairwise_case(d, chunk)
    fwd, bwd = _host_kxy(smc._host_shim(), inv_l, xs, chunk)
    x3 = xs.double().reshape(-1, chunk, d)
    diff = x3[:, :, None, :] - x3[:, None, :, :]                     # (chunks, C, C, D)
    k = torch.exp(-0.5 * torch.sum((diff * inv_l.double()) ** 2, -1))
    assert _rel(fwd.double(), k.sum((1, 2))) < F32_REL
    assert _rel(bwd.double(), 0.5 * torch.einsum("nrc,nrcd->nd", k, diff ** 2)) < F32_REL


def test_header_limits_match_the_module():
    src = open(smc._build.CSRC + "/student_mc_rows.cuh").read()
    for macro, value in (("SMC_MAX_D", smc.MAX_D), ("SMC_MAX_N", smc.MAX_N),
                         ("SMC_KXY_MAX_CHUNK", smc.KXY_MAX_CHUNK)):
        assert f"#define {macro} {value} " in src, macro
    # the pairwise block: a square grid of threads, a square micro-tile each,
    # and a largest chunk of whole tiles (so a padded chunk never exceeds it)
    m = {k: int(v) for k, v in re.findall(r"#define SMC_KXY_(\w+) (\d+) ", src)}
    assert m["THREADS"] == m["GRID"] ** 2 and m["TILE"] == m["GRID"] * m["MICRO"]
    assert m["MAX_CHUNK"] % m["TILE"] == 0 and m["THREADS"] % 32 == 0


# ---------------------------------------------------------------------------
# wrappers: CPU dispatch, launch counts, input checks
# ---------------------------------------------------------------------------

def test_wrappers_on_cpu_run_the_plain_versions_and_count_no_launch():
    samples, x, par = _fused_case(2, 4, 64, 3, seed=30)
    xs = torch.as_tensor(samples)
    inv_l = torch.tensor([0.5, 0.8], dtype=torch.float32)
    xp = torch.as_tensor(x.T).float().contiguous()
    before = dict(smc.LAUNCHES)
    torch.testing.assert_close(smc.qrq_sums(inv_l, xs, xp, 64),
                               smc._qrq_partials_plain(inv_l, xs, xp, 64).double().sum(0))
    smc.kxy_chunk_sums(inv_l, xs, 64)
    smc.kxy_bwd_sums(inv_l, xs, 64)
    assert smc.LAUNCHES == before


def test_wrappers_check_their_inputs():
    xs = torch.zeros((2048, 2))
    inv_l = torch.ones(2)
    xp = torch.zeros((5, 2))
    with pytest.raises(TypeError, match="float32"):
        smc.qrq_sums(inv_l, xs.double(), xp, 1024)
    with pytest.raises(ValueError, match="D <= 8"):
        smc.qrq_sums(torch.ones(9), torch.zeros((1024, 9)), torch.zeros((5, 9)), 1024)
    with pytest.raises(ValueError, match="N <= 128"):
        smc.qrq_sums(inv_l, xs, torch.zeros((129, 2)), 1024)
    with pytest.raises(ValueError, match="whole chunks"):
        smc.qrq_sums(inv_l, xs, xp, 1000)
    with pytest.raises(ValueError, match="2..1024"):
        smc.kxy_chunk_sums(inv_l, xs, 2048)
    with pytest.raises(ValueError, match="contiguous"):
        smc.kxy_chunk_sums(inv_l, torch.zeros((2, 2048)).T, 1024)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        smc.kxy_chunk_sums(inv_l.to("meta"), xs.to("meta"), 1024)
