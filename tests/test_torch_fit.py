"""Batched NLML fitting of the PyTorch port (``ssmtoybox_torch/parallel/fit.py``)
against the JAX package's ``ssmtoybox_tpu/parallel/fit.py``.

The same function observations (the UNGM dynamics at the GP model's UT
points, scaled around simulated states) go through both packages.  The NLML
and its gradient are held at 1e-10 relative; 20 steps of Adam (optax's
``adam`` in the JAX package, ``torch.optim.Adam`` in the port: the same
formula, rounded in another order) at 1e-9.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssmtoybox_tpu.bq.models import GaussianProcessModel as JGPModel
from ssmtoybox_tpu.parallel import fit as jfit
from ssmtoybox_torch import set_device, ssmod
from ssmtoybox_torch.bq.models import GaussianProcessModel
from ssmtoybox_torch.parallel import fit_kernel_params, make_fit_step, make_mesh, nlml_loss
from ssmtoybox_torch.utils import GaussRV

TOL = 1e-10
ADAM_TOL = 1e-9


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
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-300),
                               err_msg=label)


@pytest.fixture(scope="module")
def problem():
    """48 sets of function observations: the UNGM dynamics at the UT points
    around states of simulated trajectories, each at its step's time; both
    packages' GP models (RBF, UT points)."""
    dyn = ssmod.UNGMTransition(GaussRV(1, cov=5.0), GaussRV(1, cov=10.0))
    x = dyn.simulate_discrete(torch.Generator().manual_seed(3), steps=12, mc_sims=4)
    gp = GaussianProcessModel(1, np.array([[1.0, 3.0]]), "rbf", "ut")
    states = x[0].T.reshape(-1, 1, 1)
    times = torch.arange(12, dtype=torch.float64).repeat(4)[:, None, None]
    fo = dyn.dyn_eval(states + gp.points.T, times)                       # (48, 3, 1)
    jgp = JGPModel.create(1, np.array([[1.0, 3.0]]), "rbf", "ut")
    return gp, jgp, fo


def test_nlml_loss_matches_jax(problem):
    gp, jgp, fo = problem
    lp = np.log([1.3, 2.5])
    want, want_g = jax.value_and_grad(lambda p: jfit.nlml_loss(jgp, p, jnp.asarray(_np(fo)),
                                                               jgp.points))(jnp.asarray(lp))
    lp_t = torch.tensor(lp, requires_grad=True)
    got = nlml_loss(gp, lp_t, fo, gp.points)
    (got_g,) = torch.autograd.grad(got, lp_t)
    _close(got, want, TOL)
    _close(got_g, want_g, TOL)


def test_weighted_nlml_loss_matches_jax(problem):
    gp, jgp, fo = problem
    w = np.linspace(0.0, 2.0, fo.shape[0])
    lp = np.log([0.7, 1.5])
    want = jfit.nlml_loss(jgp, jnp.asarray(lp), jnp.asarray(_np(fo)), jgp.points,
                          weights=jnp.asarray(w))
    got = nlml_loss(gp, torch.tensor(lp), fo, gp.points, weights=torch.tensor(w))
    _close(got, want, TOL)
    # zero weights drop their rows: the mean over the rest
    half = np.r_[np.ones(24), np.zeros(24)]
    _close(nlml_loss(gp, torch.tensor(lp), fo, gp.points, weights=torch.tensor(half)),
           nlml_loss(gp, torch.tensor(lp), fo[:24], gp.points), TOL)


def test_twenty_adam_steps_match_optax(problem):
    gp, jgp, fo = problem
    want_lp, want_losses = jfit.fit_kernel_params(jgp, jnp.zeros(2), jnp.asarray(_np(fo)),
                                                  jgp.points, num_steps=20)
    lp, losses = fit_kernel_params(gp, np.zeros(2), fo, gp.points, num_steps=20)
    assert losses.shape == (20,) and float(losses[-1]) < float(losses[0])
    _close(losses, want_losses, ADAM_TOL, "losses")
    _close(lp, want_lp, ADAM_TOL, "log-parameters")


def test_fit_step_updates_the_optimizer_parameter(problem):
    """``make_fit_step`` takes any ``torch.optim`` optimizer over the
    log-parameter tensor and returns the loss before its step."""
    gp, _, fo = problem
    lp = torch.zeros(2, dtype=torch.float64, requires_grad=True)
    step = make_fit_step(gp, torch.optim.SGD([lp], lr=1e-3))
    before = nlml_loss(gp, lp.detach(), fo, gp.points)
    loss = step(fo, gp.points)
    _close(loss, before, 0.0)
    assert not torch.equal(lp.detach(), torch.zeros(2, dtype=torch.float64))
    assert float(nlml_loss(gp, lp.detach(), fo, gp.points)) < float(before)


def test_a_mesh_of_one_rank_fits_as_without_one(problem):
    """A mesh of one rank (no process group): the weighted sums and the one
    ``all_reduce`` a step give the unsharded fit to rounding."""
    gp, _, fo = problem
    want_lp, want_losses = fit_kernel_params(gp, np.zeros(2), fo, gp.points, num_steps=20)
    lp, losses = fit_kernel_params(gp, np.zeros(2), fo, gp.points, num_steps=20,
                                   mesh=make_mesh())
    _close(losses, want_losses, ADAM_TOL, "losses")
    _close(lp, want_lp, ADAM_TOL, "log-parameters")
