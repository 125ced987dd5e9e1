"""The Gaussian UNGM studies of the port (``ssmtoybox_torch/experiments``:
``icinco_ungm``, ``bsq_ungm``, ``gpqd_demo``, ``marginal_ungm``) against the
JAX package's scripts (``experiments/``), at tiny sizes on the CPU.

Each JAX script's ``main`` runs up to its filter bank (``setup_jax`` and
``print_tables`` patched out, ``run_filter_bank`` replaced by a recorder,
tiny flags: ``torch_experiments_bridge.TINY``); the port's ``build`` makes
its bank from the same flags.  Tolerances:

- models, noise RVs, points and the transforms' weights (``wm``, ``Wc``,
  ``Wcc``, ``model_var``) at 1e-12 of each array's largest entry, the same
  float64 formulas; for a BQ rule on an ill-conditioned Gram matrix ``K``
  the rounding of its solves where that is larger, ``4 eps cond(K)``
  (``cond(K)^2`` for ``Wc``; ``torch_experiments_bridge.weight_tol``);
- ``icinco_ungm`` end to end on UKF and GPQKF-UT: every score of the
  port's harness within 1e-8 relative of the JAX harness's on the JAX
  script's data, ``diverged`` equal;
- ``gpqd_demo``: each transform's mean and covariance within 1e-10 of the
  JAX transform's, given the same input moments.

The flags and defaults of all nine scripts are held here too.
"""
import argparse
import importlib
import sys
from unittest import mock

import pytest
import torch

from ssmtoybox_torch import set_device

from torch_experiments_bridge import (TINY, both_harnesses, close, compare_banks, port_study,
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


@pytest.mark.parametrize("name", ["icinco_ungm", "bsq_ungm", "gpqd_demo", "marginal_ungm"])
def test_bank_matches_jax(monkeypatch, name):
    """The port's bank of each study equals the JAX script's: filter names
    and classes, models, noise RVs, weights (see the module docstring)."""
    rec = run_jax_script(monkeypatch, name, TINY[name])
    _, port = port_study(name, TINY[name])
    compare_banks(port.algs, rec["algs"], tol=1e-12)


@pytest.mark.parametrize("name", sorted(TINY))
def test_flags_and_defaults_match_jax(name):
    """Each port module takes its JAX script's flags with the same defaults,
    plus ``--device`` (default ``cuda``)."""
    jmod = importlib.import_module(f"experiments.{name}")
    seen = {}

    def grab(self, args=None, namespace=None):
        seen.update(vars(argparse.ArgumentParser.parse_known_args(self, [])[0]))
        raise SystemExit

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab), \
            mock.patch.object(sys, "argv", [name]):
        with pytest.raises(SystemExit):
            jmod.main()
    port = vars(importlib.import_module(f"ssmtoybox_torch.experiments.{name}").parse([]))
    assert port.pop("device") == "cuda"
    assert port == seen


def test_icinco_study_scores_match_jax(monkeypatch):
    """``icinco_ungm`` end to end on the UKF and GPQKF-UT lanes: the JAX
    script's data through both harnesses, every score within 1e-8."""
    rec = run_jax_script(monkeypatch, "icinco_ungm", TINY["icinco_ungm"])
    _, port = port_study("icinco_ungm", TINY["icinco_ungm"])
    names = ("UKF", "GPQKF-UT")
    prows, jdf = both_harnesses({n: port.algs[n] for n in names},
                                {n: rec["algs"][n] for n in names}, rec)
    scores_agree(prows, jdf, names)


def test_gpqd_transforms_match_jax(monkeypatch):
    """``gpqd_demo``: the GPQ and GPQ+D transforms' moments of
    ``sin(x) + x^2 / 2`` within 1e-10 of the JAX script's."""
    rec = run_jax_script(monkeypatch, "gpqd_demo", TINY["gpqd_demo"], record_skl=True)
    mod, b = port_study("gpqd_demo", TINY["gpqd_demo"])
    assert len(rec["skl"]) == len(b.transforms)
    for (what, tf), (_, _, jm, jc) in zip(b.transforms.items(), rec["skl"]):
        mf, cf, _ = tf.apply(mod.sin_quad, b.mean, b.cov, None)
        close(mf, jm, 1e-10, f"{what} mean")
        close(cf, jc, 1e-10, f"{what} cov")
