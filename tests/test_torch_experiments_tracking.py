"""The tracking and transform studies of the port
(``ssmtoybox_torch/experiments``: ``gpq_tracking``, ``bsq_tracking``,
``polar2cartesian_mt``) against the JAX package's scripts
(``experiments/``), at tiny sizes on the CPU.

Each JAX script's ``main`` runs up to its filter bank (``setup_jax`` and
``print_tables`` patched out, ``run_filter_bank`` replaced by a recorder,
tiny flags: ``torch_experiments_bridge.TINY``); the port's ``build`` makes
its bank from the same flags.  Tolerances:

- models, noise RVs, points and the transforms' weights (``wm``, ``Wc``,
  ``Wcc``, ``model_var``) at 1e-12 of each array's largest entry, the same
  float64 formulas; for a BQ rule on an ill-conditioned Gram matrix ``K``
  the rounding of its solves where that is larger, ``4 eps cond(K)``
  (``cond(K)^2`` for ``Wc``; ``torch_experiments_bridge.weight_tol``);
- ``polar2cartesian_mt``: every transform's mean and covariance within
  1e-10 of the JAX transform's, given the same input moments.
"""
import pytest
import torch

from ssmtoybox_torch import set_device

from torch_experiments_bridge import TINY, close, compare_banks, port_study, run_jax_script


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


@pytest.mark.parametrize("name", ["gpq_tracking", "bsq_tracking"])
def test_bank_matches_jax(monkeypatch, name):
    """The port's bank of each study equals the JAX script's: filter names
    and classes, models (the truth's are not in the bank), noise RVs,
    weights, the EMV overrides of the BSQ filters."""
    rec = run_jax_script(monkeypatch, name, TINY[name])
    _, port = port_study(name, TINY[name])
    compare_banks(port.algs, rec["algs"], tol=1e-12)


def test_polar2cartesian_transforms_match_jax(monkeypatch):
    """``polar2cartesian_mt``: every transform's mean and covariance (the
    first table's seven, then UT and truncated UT at dimensions 2, 3, 5, 8)
    within 1e-10 of the JAX script's, at the same input moments."""
    name = "polar2cartesian_mt"
    rec = run_jax_script(monkeypatch, name, TINY[name], record_skl=True)
    mod, b = port_study(name, TINY[name])
    tfs = [(n, tf, b.mean, b.cov) for n, tf in b.transforms.items()]
    for dim, (ut, tut) in b.truncated.items():
        tfs += [(f"UT dim {dim}", ut, *b.moments[dim]), (f"TUT dim {dim}", tut, *b.moments[dim])]
    assert len(rec["skl"]) == len(tfs)
    for (what, tf, mean, cov), (_, _, jm, jc) in zip(tfs, rec["skl"]):
        mf, cf, _ = tf.apply(mod.polar2cartesian, mean, cov, None)
        close(mf, jm, 1e-10, f"{what} mean")
        close(cf, jc, 1e-10, f"{what} cov")


def test_gpq_reentry_rule_keeps_the_variance_of_a_constant():
    """The reentry study's GPQ rule (length-scale 25 on the 5-D UT points,
    ``cond(K) = 1.9e6``): ``1^T Wc 1 - (1^T wm)^2``, the variance a filter
    gives a constant integrand (scaled there by a position near 6,400 km
    squared), within 25% of its value in long-double arithmetic from the
    same Gram matrix and kernel expectations.  ``Wc = K^-1 Q K^-1`` formed
    directly gets it wrong by more than its size, with a sign that depends
    on the order of the products; on the card the GPQKF then lost every
    run."""
    import numpy as np

    _, b = port_study("gpq_tracking", TINY["gpq_tracking"])
    tf = b.algs["GPQKF"].tf_dyn
    kern, x = tf.model.kernel, tf.model.points
    par = kern.get_parameters(None)
    q, _, Q = (t.numpy().astype(np.longdouble) for t in kern.exp_x_qRQ(par, x))
    # the jittered Gram matrix the weights use, inverted by Gauss-Jordan in long double
    A = kern._jittered(par, x, False).numpy().astype(np.longdouble)
    n = A.shape[0]
    G = np.hstack([A, np.eye(n, dtype=np.longdouble)])
    for i in range(n):
        G[i] /= G[i, i]
        for j in range(n):
            if j != i:
                G[j] -= G[j, i] * G[i]
    iK = G[:, n:]
    wm = q @ iK
    want = float((iK @ Q @ iK).sum() - wm.sum() ** 2)
    got = float(tf.Wc.sum() - tf.wm.sum() ** 2)
    assert want > 0
    assert abs(got - want) <= 0.25 * want, (got, want)
