"""The rest of the PyTorch port's ``utils`` (``bootstrap_var``,
``print_table``, ``vandermonde_np``, ``RandomVariable``) against the JAX
package's ``ssmtoybox_tpu/utils``, and the port's flat namespaces against the
JAX package's.

A JAX key and a torch generator draw different resamples, so
``bootstrap_var`` is held statistically: both packages within 5% of the
variance of the sample mean (the standard error of a variance over 20,000
resamples is ~1%).  The rest is exact.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import jax

import ssmtoybox_tpu.parallel as jparallel
import ssmtoybox_tpu.utils as jutils
from ssmtoybox_tpu.utils.combin import vandermonde_np as jvandermonde_np
from ssmtoybox_tpu.utils.metrics import bootstrap_var as jbootstrap_var
from ssmtoybox_tpu.utils.metrics import print_table as jprint_table
import ssmtoybox_torch.parallel as tparallel
import ssmtoybox_torch.utils as tutils
from ssmtoybox_torch import set_device
from ssmtoybox_torch.utils import (GaussianMixtureRV, GaussRV, RandomVariable, StudentRV,
                                   bootstrap_var, print_table, vandermonde_np)
from ssmtoybox_torch.utils.combin import total_degree_multi_index


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


def test_bootstrap_var_estimates_the_variance_of_the_mean():
    data = np.random.default_rng(0).gamma(2.0, 1.5, size=400)
    want = data.var() / data.size
    got = bootstrap_var(torch.Generator().manual_seed(1), torch.from_numpy(data), samples=20_000)
    ref = jbootstrap_var(jax.random.PRNGKey(1), data, samples=20_000)
    assert got.dtype == torch.float64 and got.shape == ()
    assert abs(float(got) / want - 1) < 0.05
    assert abs(float(ref) / want - 1) < 0.05
    # the resamples come from the generator: one seed, one value
    again = bootstrap_var(torch.Generator().manual_seed(1), torch.from_numpy(data), samples=20_000)
    assert torch.equal(got, again)


def test_print_table_matches_jax(capsys):
    data = np.arange(6.0).reshape(2, 3) / 7
    rows, cols = ["ukf", "gpq"], ["rmse", "nci", "inc"]
    want = jprint_table(data, rows, cols, latex=True)
    want_out = capsys.readouterr().out
    got = print_table(torch.from_numpy(data), rows, cols, latex=True)
    assert capsys.readouterr().out == want_out
    pd.testing.assert_frame_equal(got, want)


def test_vandermonde_np_matches_jax():
    mul = total_degree_multi_index(3, 3)
    x = np.random.default_rng(2).normal(size=(3, 11))
    assert np.array_equal(vandermonde_np(mul, x), jvandermonde_np(mul, x))


def test_random_variable_is_the_base_of_the_rvs():
    rvs = (GaussRV(2), StudentRV(2), GaussianMixtureRV(1, [0.0, 1.0], [1.0, 2.0], [0.5, 0.5]))
    for rv in rvs:
        assert isinstance(rv, RandomVariable)
    assert {c.__name__ for c in RandomVariable.__subclasses__()} == \
        {"GaussRV", "StudentRV", "GaussianMixtureRV"}
    with pytest.raises(NotImplementedError):
        RandomVariable().get_stats()


def test_namespaces_hold_the_jax_names():
    assert tutils.__all__ == jutils.__all__
    assert all(hasattr(tutils, n) for n in tutils.__all__)
    missing = [n for n in jparallel.__all__ if n not in tparallel.__all__]
    assert not missing, missing
    assert all(hasattr(tparallel, n) for n in tparallel.__all__)
    assert "associative_scan" in tparallel.__all__
