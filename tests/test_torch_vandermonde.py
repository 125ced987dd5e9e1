"""Multi-indices and the Vandermonde matrix of the PyTorch port
(``ssmtoybox_torch/utils/combin.py``, ``ssmtoybox_torch/ops/vandermonde.py``).

On the CPU the wrapper runs the kernel's plain PyTorch version, held against:

- the JAX package's exact float64 ``utils/combin.py::vandermonde`` at rtol
  1e-14: the port multiplies repeatedly, the JAX package raises to integer
  powers by binary exponentiation, so they differ by about an ulp;
- the JAX package's Pallas kernel ``ops/pallas_ops.py::vandermonde`` in
  interpret mode at rtol 1e-6 (``tests/test_pallas_ops.py``'s): that kernel
  computes in float32.

The CUDA point header, compiled for the host with g++, equals the plain
version to the bit (same products in the same order), with the coordinates
in registers (D <= 8) and read again a column (D = 9).  The kernel itself
runs only on the card: ``tests/test_torch_cuda.py``.  The wrapper's cache of
validated multi-indices is held to serve every multi-index its own matrix.
"""
import shutil

import numpy as np
import pytest
import torch

from ssmtoybox_tpu.ops.pallas_ops import vandermonde as jax_pallas_vandermonde
from ssmtoybox_tpu.utils import combin as jcombin
from ssmtoybox_torch import set_device
from ssmtoybox_torch.ops import vandermonde as vdm
from ssmtoybox_torch.utils import combin


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


# (D, multi-index): the BSQ studies' bases (UNGM UT and GH-7, the 5-D
# reentry basis, a total-degree basis) and one with exponents up to 9
MUL_UT5 = np.hstack((np.zeros((5, 1), int), np.eye(5, dtype=int), 2 * np.eye(5, dtype=int)))
CASES = {
    "ut1": np.array([[0, 1, 2]]),
    "gh7": np.atleast_2d(np.arange(7)),
    "ut5": MUL_UT5,
    "td3_4": jcombin.total_degree_multi_index(3, 4),
    "high": np.array([[9, 0, 3, 1], [2, 5, 0, 1]]),
    "d9": np.vstack((np.eye(9, dtype=int), [[2, 0, 1, 0, 3, 0, 0, 1, 2]])).T,
    "wide40": np.atleast_2d(np.arange(40) % 6),
}


def _points(dim, n, seed):
    return np.random.default_rng(seed).normal(0.0, 1.7, size=(dim, n))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("fn", ["n_sum_k", "n_sum_k_complete", "total_degree_multi_index"])
def test_multi_indices_equal_the_jax_package(fn, n):
    """Column for column, k (or the degree) 0-4; ``n_sum_k`` keeps the
    reference's incomplete recursion."""
    for k in range(5):
        got, want = getattr(combin, fn)(n, k), getattr(jcombin, fn)(n, k)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=f"{fn}({n}, {k})")


def test_n_sum_k_keeps_the_reference_gaps():
    assert combin.n_sum_k(3, 4).shape[1] == 12           # 3 of the 15 tuples left out
    assert combin.n_sum_k_complete(3, 4).shape[1] == 15
    assert combin.n_sum_k(4, 3).shape[1] == 16           # 4 of 20
    with pytest.raises(ValueError):
        combin.n_sum_k(2, -1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_exact_vandermonde(case):
    mul = CASES[case]
    x = _points(mul.shape[0], 37, seed=len(case))
    got = combin.vandermonde(mul, torch.as_tensor(x))
    want = np.asarray(jcombin.vandermonde(mul, x))
    assert tuple(got.shape) == (37, mul.shape[1]) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)


@pytest.mark.parametrize("case", ["ut1", "ut5", "td3_4"])
def test_plain_matches_jax_pallas_kernel(case):
    mul = CASES[case]
    x = _points(mul.shape[0], 20, seed=7)
    got = combin.vandermonde(mul, torch.as_tensor(x))
    want = np.asarray(jax_pallas_vandermonde(mul, x, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_entry_header_on_host_matches_plain(case):
    """``csrc/vandermonde_cols.cuh`` (the per-point routine) built with g++ ==
    the plain version, to the bit, with zeros, negatives and large values
    among the points."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the entry header cannot be built for the host")
    mul = CASES[case]
    x = _points(mul.shape[0], 53, seed=11)
    x[:, 0], x[:, 1], x[:, 2] = 0.0, -2.5, 40.0
    xt = torch.as_tensor(x)
    host = vdm._host_shim_run(mul, xt)
    plain = vdm.vandermonde_plain(mul, xt)
    assert torch.equal(host, plain)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    x = torch.as_tensor(_points(5, 9, seed=1))
    before = vdm.LAUNCHES
    got = vdm.vandermonde(MUL_UT5, x)
    assert torch.equal(got, vdm.vandermonde_plain(MUL_UT5, x))
    assert vdm.LAUNCHES == before
    # zeroth powers are 1, also of zero; an empty point set gives (0, Q)
    assert torch.equal(vdm.vandermonde([[0]], torch.zeros((1, 2), dtype=torch.float64)),
                       torch.ones((2, 1), dtype=torch.float64))
    assert tuple(vdm.vandermonde(MUL_UT5, torch.zeros((5, 0), dtype=torch.float64)).shape) == (0, 11)


def test_every_multi_index_gets_its_own_matrix():
    """The cache of validated multi-indices is keyed by content: a second
    multi-index of the same shape and a changed array get their own result,
    and what was refused once is refused again."""
    x = torch.as_tensor(_points(2, 6, seed=5))
    a, b = np.array([[1, 0, 2], [0, 1, 1]]), np.array([[0, 2, 1], [1, 1, 0]])
    va, vb = vdm.vandermonde(a, x), vdm.vandermonde(b, x)
    assert torch.equal(va, vdm.vandermonde_plain(a, x))
    assert torch.equal(vb, vdm.vandermonde_plain(b, x)) and not torch.equal(va, vb)
    assert vdm._index(a, 2) is vdm._index(a.copy(), 2)                 # one entry a content
    assert vdm._index(a, 2) is vdm._index(a.tolist(), 2)
    a[0, 0] = 3                                                        # changed in place
    assert torch.equal(vdm.vandermonde(a, x), vdm.vandermonde_plain(a, x))
    assert float(vdm.vandermonde(a, x)[0, 0]) == float(x[0, 0]) ** 3
    for _ in range(2):
        with pytest.raises(ValueError, match="negative"):
            vdm.vandermonde([[1, -1], [0, 2]], x)
    before = len(vdm._INDICES)
    for k in range(vdm._CACHE_SIZE + 3):                               # bounded
        vdm.vandermonde([[k], [1]], x)
    assert len(vdm._INDICES) <= vdm._CACHE_SIZE and before <= vdm._CACHE_SIZE
    assert vdm._index(b, 2).e32.dtype == np.int32 and vdm._index(b, 2).e32.flags.c_contiguous


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.as_tensor(_points(2, 4, seed=2))
    before = vdm.LAUNCHES
    with pytest.raises(ValueError, match="negative"):
        vdm.vandermonde([[1, -1], [0, 2]], x)
    with pytest.raises(ValueError, match="dimension"):
        vdm.vandermonde([[1, 2, 3]], x)
    with pytest.raises(ValueError, match="float64"):
        vdm.vandermonde([[1], [0]], x.float())
    with pytest.raises(ValueError, match="contiguous"):
        vdm.vandermonde([[1, 2], [0, 1]], torch.as_tensor(_points(4, 2, seed=3)).T)
    with pytest.raises(ValueError, match="integer"):
        vdm.vandermonde([[1.0], [0.5]], x)
    with pytest.raises(ValueError, match="D <= 32"):
        vdm.vandermonde(np.ones((33, 1), int), torch.zeros((33, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="shared memory"):
        vdm.vandermonde(np.ones((2, 6145), int), x)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        vdm.vandermonde([[1], [0]], x.to("meta"))
    assert vdm.LAUNCHES == before
