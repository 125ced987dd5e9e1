"""Tests of the port that need a CUDA card; they skip without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch, where the repository's conftest (which pins
JAX to the CPU) cannot load:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import ssmtoybox_torch as stt
from ssmtoybox_torch.ops import scalar_filter as sf
from ssmtoybox_torch.ssmod import UNGMMeasurement, UNGMTransition
from ssmtoybox_torch.utils import GaussRV

pytestmark = pytest.mark.cuda

KERN_PAR = np.array([[1.0, 3.0]])
STREAMS = ("m_fi", "P_fi", "m_pr", "P_pr", "xx")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _algs(device):
    dyn = UNGMTransition(GaussRV(1, cov=5.0, device=device), GaussRV(1, cov=10.0, device=device))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0, device=device), dim_state=1)
    return {"ukf": stt.UnscentedKalman(dyn, obs),
            "gpqkf": stt.GaussianProcessKalman(dyn, obs, KERN_PAR, KERN_PAR)}


@pytest.mark.parametrize("name", ["ukf", "gpqkf"])
def test_kernel_matches_twin(card, name):
    """Kernel vs twin, both on the card: one step at 1e-13, 20 steps at 1e-9
    (the kernel is built without FMA contraction and agrees to the bit)."""
    alg = _algs(card)[name]
    params = sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    rng = np.random.default_rng(4)
    y = torch.as_tensor(rng.normal(2.0, 4.0, size=(20, 4096)), device=card)
    c = torch.as_tensor(sf.ungm_consts(20), device=card)
    for n_steps, tol in ((1, 1e-13), (20, 1e-9)):
        yy, cc = y[:n_steps].contiguous(), c[:n_steps].contiguous()
        before = sf.LAUNCHES
        got = sf.scalar_filter(params, yy, cc)
        assert sf.LAUNCHES == before + 1
        for s, a, b in zip(STREAMS, got, sf._scalar_filter_plain(params, yy, cc)):
            torch.testing.assert_close(a, b, atol=tol, rtol=tol, msg=s)


@pytest.mark.parametrize("name", ["ukf", "gpqkf"])
def test_fused_engine_matches_eager_f64_on_the_card(card, name):
    """``engine="dd"`` (the kernel) against the eager batched f64 path on 20
    steps, 1e-9: the two sum in different orders."""
    alg = _algs(card)[name]
    gen = torch.Generator(device=card).manual_seed(1)
    x = alg.mod_dyn.simulate_discrete(gen, steps=20, mc_sims=512)
    ys = alg.mod_obs.simulate_measurements(gen, x).permute(2, 0, 1)
    fused, eager = alg.forward_pass_batch(ys, engine="dd"), alg.forward_pass_batch(ys)
    for f in ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov"):
        torch.testing.assert_close(getattr(fused, f), getattr(eager, f), atol=1e-9, rtol=1e-9,
                                   msg=f)
