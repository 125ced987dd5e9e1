"""The Student-t studies of the port (``ssmtoybox_torch/experiments``:
``tpq_ungm``, ``tpq_constant_velocity``) against the JAX package's scripts
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
- the Student-kernel BQ weights are Monte-Carlo estimates drawn from
  other random streams in the two packages: shapes only;
- ``tpq_constant_velocity`` end to end on UKF and TPQSF, the TPQSF's
  weights carried across from the JAX transforms
  (``convert.transform_from_numpy``): every score of the port's harness
  within 1e-8 relative of the JAX harness's on the JAX script's data,
  ``diverged`` equal.
"""
import pytest
import torch

from ssmtoybox_torch import set_device

from torch_experiments_bridge import (TINY, both_harnesses, carry, compare_banks, port_study,
                                      run_jax_script, scores_agree)


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


#: the filters whose transforms carry Monte-Carlo weights
MC_WEIGHTS = {"tpq_ungm": ("TPQSF-3", "TPQSF-10", "TPQSF-500"),
              "tpq_constant_velocity": ("TPQSF(nu=4)", "GPQSF")}


@pytest.mark.parametrize("name", sorted(MC_WEIGHTS))
def test_bank_matches_jax(monkeypatch, name):
    """The port's bank of each study equals the JAX script's: filter names
    and classes, models, noise RVs, closed-form weights; the Monte-Carlo
    weights' shapes."""
    rec = run_jax_script(monkeypatch, name, TINY[name])
    _, port = port_study(name, TINY[name])
    compare_banks(port.algs, rec["algs"], tol=1e-12, mc_weights=MC_WEIGHTS[name])


def test_cv_glint_study_scores_match_jax(monkeypatch):
    """``tpq_constant_velocity`` end to end on the UKF and TPQSF lanes, the
    TPQSF's Monte-Carlo weights carried across from the JAX transforms:
    every score within 1e-8, the same diverged runs."""
    name = "tpq_constant_velocity"
    rec = run_jax_script(monkeypatch, name, TINY[name])
    _, port = port_study(name, TINY[name])
    tpq, jtpq = port.algs["TPQSF(nu=4)"], rec["algs"]["TPQSF(nu=4)"]
    tpq.tf_dyn, tpq.tf_obs = carry(jtpq.tf_dyn), carry(jtpq.tf_obs)
    names = ("UKF", "TPQSF(nu=4)")
    prows, jdf = both_harnesses({n: port.algs[n] for n in names},
                                {n: rec["algs"][n] for n in names}, rec)
    scores_agree(prows, jdf, names)
