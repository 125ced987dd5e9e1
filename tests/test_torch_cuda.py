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


# ---------------------------------------------------------------------------
# the RBF-Student Monte-Carlo kernels (ops/student_mc.py, csrc/student_mc.cu)
# float32 with float64 cross-chunk sums on both sides: values at 1e-5
# relative, gradients at rtol 1e-4 / atol 1e-5
# ---------------------------------------------------------------------------

def _student_case(card, d, n, total, seed):
    rng = np.random.default_rng(seed)
    samples = torch.as_tensor(rng.standard_t(4.0, size=(total, d)).astype(np.float32),
                              device=card)
    x = torch.as_tensor(rng.normal(0.0, 1.5, size=(d, n)), device=card)
    par = torch.as_tensor(np.concatenate([[1.3], rng.uniform(0.7, 2.0, d)])[None], device=card)
    return samples, x, par


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# (D, N, chunk): the CV glint study's shape, ragged tiles at the limits, the
# FS degree-5 rule at D = 4 (N = 33) and the large path's shapes just past
# the small one (D = 5, N = 11) and with points not a multiple of 4 (N = 81)
STUDENT_SHAPES = [(4, 9, 4096), (3, 7, 300), (8, 128, 1024), (1, 1, 8), (4, 33, 4096),
                  (5, 11, 1000), (2, 81, 300)]


@pytest.mark.parametrize("d,n,chunk", STUDENT_SHAPES)
def test_student_qrq_kernels_match_plain(card, d, n, chunk):
    from ssmtoybox_torch.ops import student_mc as smc
    samples, x, par = _student_case(card, d, n, 6 * chunk, seed=d + n)
    before = dict(smc.LAUNCHES)
    p, xx = par.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out = smc.student_qrq(p, xx, samples, chunk)
    p2, xx2 = par.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ref = smc.student_qrq_plain(p2, xx2, samples, chunk)
    for a, b in zip(out, ref):
        assert _rel(a.detach(), b.detach()) < 1e-5
    w = [torch.randn(t.shape, generator=torch.Generator(device=card).manual_seed(i),
                     dtype=torch.float64, device=card) for i, t in enumerate(ref)]
    g = torch.autograd.grad(sum(torch.sum(wi * o) for wi, o in zip(w, out)), (p, xx))
    g_ref = torch.autograd.grad(sum(torch.sum(wi * o) for wi, o in zip(w, ref)), (p2, xx2))
    for a, b in zip(g, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert float(g[0][0, 0]) == 0.0
    assert smc.LAUNCHES["qrq"] == before["qrq"] + 1
    assert smc.LAUNCHES["qrq_bwd"] == before["qrq_bwd"] + 1


# (D, chunk): the study's shape, ragged and tiny chunks, one and two planes
KXY_SHAPES = [(4, 1024), (3, 300), (8, 1024), (1, 8), (2, 2), (5, 1000), (8, 64)]


@pytest.mark.parametrize("d,chunk", KXY_SHAPES)
def test_student_kxy_kernels_match_plain(card, d, chunk):
    from ssmtoybox_torch.ops import student_mc as smc
    samples, _, par = _student_case(card, d, 1, 5 * chunk, seed=40 + d)
    before = dict(smc.LAUNCHES)
    p, p2 = par.clone().requires_grad_(True), par.clone().requires_grad_(True)
    v, v_ref = smc.student_kxy(p, samples, chunk), smc.student_kxy_plain(p2, samples, chunk)
    assert abs(float(v) - float(v_ref)) / abs(float(v_ref)) < 1e-5
    (g,), (g_ref,) = torch.autograd.grad(v, p), torch.autograd.grad(v_ref, p2)
    torch.testing.assert_close(g, g_ref, rtol=1e-4, atol=1e-5)
    assert smc.LAUNCHES["kxy"] == before["kxy"] + 1
    assert smc.LAUNCHES["kxy_bwd"] == before["kxy_bwd"] + 1


@pytest.mark.parametrize("d,chunk", [(4, 1024), (5, 1000), (8, 64)])
def test_student_kxy_kernels_repeat_to_the_bit(card, d, chunk):
    """No atomics and a fixed order of summation: two launches on the same
    input give the same bits, per chunk."""
    from ssmtoybox_torch.ops import student_mc as smc
    samples, _, par = _student_case(card, d, 1, 7 * chunk, seed=60 + d)
    _, inv_l, _ = smc._kernel_args(par)
    for fn in (smc.kxy_chunk_sums, smc.kxy_bwd_sums):
        a, b = fn(inv_l, samples, chunk), fn(inv_l, samples, chunk)
        torch.cuda.synchronize()
        assert torch.equal(a, b) and bool(torch.isfinite(a).all()), fn.__name__


@pytest.mark.parametrize("d,n,chunk", [(4, 9, 4096), (4, 33, 4096), (8, 128, 1024), (3, 7, 300)])
def test_student_qrq_kernels_repeat_to_the_bit(card, d, n, chunk):
    """No atomics and a fixed order of summation: two launches of the q/R/Q
    kernels (small and large path) on the same input give the same bits."""
    from ssmtoybox_torch.ops import student_mc as smc
    samples, x, par = _student_case(card, d, n, 5 * chunk, seed=80 + d + n)
    _, inv_l, xp = smc._kernel_args(par, x)
    gq, gR, gQ = (torch.randn(s, generator=torch.Generator(device=card).manual_seed(d),
                              device=card) for s in ((n,), (d, n), (n, n)))
    gQ2 = (gQ + gQ.T).contiguous()
    for fn in (lambda: smc.qrq_sums(inv_l, samples, xp, chunk),
               lambda: smc.qrq_bwd_sums(inv_l, samples, xp, gq, gR, gQ2, chunk)):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())


def test_student_kernels_refuse_shapes_beyond_their_limits(card):
    from ssmtoybox_torch.ops import student_mc as smc
    before = dict(smc.LAUNCHES)
    xs = torch.zeros((2048, 9), device=card)
    with pytest.raises(ValueError, match="D <= 8"):
        smc.qrq_sums(torch.ones(9, device=card), xs, torch.zeros((5, 9), device=card), 1024)
    with pytest.raises(ValueError, match="N <= 128"):
        smc.qrq_sums(torch.ones(2, device=card), xs[:, :2].contiguous(),
                     torch.zeros((129, 2), device=card), 1024)
    with pytest.raises(ValueError, match="2..1024"):
        smc.kxy_chunk_sums(torch.ones(2, device=card), xs[:, :2].contiguous(), 2048)
    assert smc.LAUNCHES == before


@pytest.mark.parametrize("use_kernel,launched", [(True, True), (False, False)])
def test_rbf_student_dispatch_on_the_card(card, use_kernel, launched):
    """``use_kernel=True`` takes the fused kernels for tensors on the card,
    ``False`` the float64 scan path; both estimate the same expectations."""
    from ssmtoybox_torch.bq.kernels import RBFStudent
    from ssmtoybox_torch.ops import student_mc as smc
    from ssmtoybox_torch.points import fs_points
    kern = RBFStudent(2, [[1.0, 1.5, 2.0]], num_samples=200_000, use_kernel=use_kernel,
                      device=card)
    x = torch.as_tensor(fs_points(2, 3, 0.0, 4.0), device=card)
    before = dict(smc.LAUNCHES)
    q, _, Q = kern.exp_x_qRQ(kern.par, x)
    kxy = kern.exp_xy_kxy(kern.par)
    assert (smc.LAUNCHES["qrq"] > before["qrq"]) == launched
    assert (smc.LAUNCHES["kxy"] > before["kxy"]) == launched
    ref = RBFStudent(2, [[1.0, 1.5, 2.0]], num_samples=200_000, use_kernel=False, device="cpu")
    x_cpu = x.cpu()
    # two Monte-Carlo estimates from different streams: 2e5 samples agree to ~1e-2
    torch.testing.assert_close(q.cpu(), ref.exp_x_kx(ref.par, x_cpu), rtol=2e-2, atol=2e-3)
    torch.testing.assert_close(Q.cpu(), ref.exp_x_kxkx(ref.par, ref.par, x_cpu), rtol=2e-2,
                               atol=2e-3)
    torch.testing.assert_close(kxy.cpu(), ref.exp_xy_kxy(ref.par), rtol=2e-2, atol=2e-3)


# ---------------------------------------------------------------------------
# the device default, rules of up to 8 points, and the Vandermonde kernel
# (ops/vandermonde.py, csrc/vandermonde.cu): bit-equal to its plain version
# ---------------------------------------------------------------------------

def test_the_card_is_the_default_device(card):
    """Built with no ``device`` argument anywhere, a UKF lives and filters on
    the card."""
    stt.set_device(None)
    dyn = UNGMTransition(GaussRV(1, cov=5.0), GaussRV(1, cov=10.0))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1)
    ukf = stt.UnscentedKalman(dyn, obs)
    assert ukf.tf_dyn.wm.device.type == "cuda" and dyn.noise_gain.device.type == "cuda"
    res = ukf.forward_pass_batch(np.zeros((3, 1, 5)), engine="dd")
    assert res.fi_mean.device.type == "cuda" and res.fi_cov.device.type == "cuda"


def test_device_none_moves_cpu_tensors_to_the_card(card):
    """CPU tensors handed to a constructor with no ``device`` land on the
    card, beside the members made from nothing."""
    from ssmtoybox_torch.bq import BQTransform
    from ssmtoybox_torch.bq.kernels import RBFStudent
    from ssmtoybox_torch.mtran import SigmaPointTransform
    from ssmtoybox_torch.utils import GaussianMixtureRV
    stt.set_device(None)
    one = lambda *shape: torch.ones(shape, dtype=torch.float64)   # noqa: E731
    built = {
        "GaussianMixtureRV": GaussianMixtureRV(1, [one(1), one(1)], [one(1, 1)] * 2,
                                               torch.tensor([0.5, 0.5])).means,
        "SigmaPointTransform": SigmaPointTransform(one(1, 3), one(3), wc_diag=one(3)).wm,
        "BQTransform": BQTransform(one(1, 3), one(3), torch.eye(3, dtype=torch.float64),
                                   one(1, 3), 1.0).Wcc,
        "RBFStudent": RBFStudent(1, one(1, 2)).par,
    }
    assert {k: t.device.type for k, t in built.items()} == {k: "cuda" for k in built}


WIDE_RULES = {
    "gh5": lambda d, o: stt.GaussHermiteKalman(d, o, deg=5),
    "gh7": lambda d, o: stt.GaussHermiteKalman(d, o, deg=7),
    "bsq_gh7": lambda d, o: stt.BayesSardKalman(
        d, o, np.array([[3.0, 0.4]]), np.array([[3.0, 0.4]]),
        mulind_dyn=np.atleast_2d(np.arange(7)), mulind_obs=np.atleast_2d(np.arange(7)),
        points="gh", point_hyp={"degree": 7}),
}


@pytest.mark.parametrize("name", sorted(WIDE_RULES))
def test_kernel_matches_twin_at_5_and_7_points(card, name):
    """The scalar filter kernel with 5- and 7-point rules equals its twin on
    the card to the bit, for one step and for 20."""
    dyn = UNGMTransition(GaussRV(1, cov=5.0, device=card), GaussRV(1, cov=10.0, device=card))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0, device=card), dim_state=1)
    alg = WIDE_RULES[name](dyn, obs)
    params = sf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    rng = np.random.default_rng(5)
    y = torch.as_tensor(rng.normal(2.0, 4.0, size=(20, 4096)), device=card)
    c = torch.as_tensor(sf.ungm_consts(20), device=card)
    for n_steps in (1, 20):
        yy, cc = y[:n_steps].contiguous(), c[:n_steps].contiguous()
        before = sf.LAUNCHES
        got = sf.scalar_filter(params, yy, cc)
        assert sf.LAUNCHES == before + 1
        for s, a, b in zip(STREAMS, got, sf._scalar_filter_plain(params, yy, cc)):
            assert torch.equal(a, b), s


def _rule_pairs(device):
    """Filters whose rules give every instantiation of the kernel: classical
    and BQ rules of 3, 5 and 7 points, and rules that run padded (4, 8)."""
    dyn = UNGMTransition(GaussRV(1, cov=5.0, device=device), GaussRV(1, cov=10.0, device=device))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0, device=device), dim_state=1)

    def bsq(par, deg):
        mi = np.atleast_2d(np.arange(deg))
        return stt.BayesSardKalman(dyn, obs, np.array(par), np.array(par), mulind_dyn=mi,
                                   mulind_obs=mi, points="gh", point_hyp={"degree": deg})

    return dyn, obs, {
        "ut": lambda: stt.UnscentedKalman(dyn, obs),
        "gh4": lambda: stt.GaussHermiteKalman(dyn, obs, deg=4),
        "gh5": lambda: stt.GaussHermiteKalman(dyn, obs, deg=5),
        "gh7": lambda: stt.GaussHermiteKalman(dyn, obs, deg=7),
        "gh8": lambda: stt.GaussHermiteKalman(dyn, obs, deg=8),
        "gpq_ut": lambda: stt.GaussianProcessKalman(dyn, obs, KERN_PAR, KERN_PAR),
        "bsq_gh5": lambda: bsq([[5.0, 0.6]], 5), "bsq_gh7": lambda: bsq([[3.0, 0.4]], 7),
        "gpq_gh8": lambda: stt.GaussianProcessKalman(
            dyn, obs, np.array([[3.0, 0.4]]), np.array([[3.0, 0.4]]), points="gh",
            point_hyp={"degree": 8})}


# (dynamics rule of, measurement rule of, slots of the instantiation)
RULE_PAIRS = [("ut", "ut", 3), ("gpq_ut", "gpq_ut", 3), ("gh5", "gh5", 5), ("bsq_gh5", "bsq_gh5", 5),
              ("gh7", "gh7", 7), ("bsq_gh7", "bsq_gh7", 7), ("bsq_gh5", "ut", 5),
              ("gh7", "gpq_ut", 7), ("gh4", "gh4", 5), ("gh5", "gh8", 8), ("gpq_gh8", "gpq_gh8", 8)]


@pytest.mark.parametrize("batch", [1, 7, 4097, 10_000])
@pytest.mark.parametrize("a,b,n_slots", RULE_PAIRS)
def test_kernel_matches_twin_at_every_instantiation(card, a, b, n_slots, batch):
    """Every instantiation the launcher can pick, at batch sizes that leave
    the last warp and the last block ragged: the kernel equals its twin to
    the bit, a second launch equals the first, and trajectory-major
    measurements (read through their strides) give the same bits."""
    dyn, obs, makers = _rule_pairs(card)
    params = sf.prepare(dyn, obs, makers[a]().tf_dyn, makers[b]().tf_obs)
    assert sf.slots(params) == n_slots
    rng = np.random.default_rng(batch)
    y = torch.as_tensor(rng.normal(2.0, 4.0, size=(30, batch)), device=card)
    c = torch.as_tensor(sf.ungm_consts(30), device=card)
    before = sf.LAUNCHES
    got = sf.scalar_filter(params, y, c)
    assert sf.LAUNCHES == before + 1
    again = sf.scalar_filter(params, y, c)
    by_traj = sf.scalar_filter(params, y.T.contiguous().T, c)
    torch.cuda.synchronize()
    for s, g, r, g2, g3 in zip(STREAMS, got, sf._scalar_filter_plain(params, y, c), again, by_traj):
        assert bool(torch.isfinite(g).all()), s
        assert torch.equal(g, r), s
        assert torch.equal(g, g2) and torch.equal(g, g3), s


def test_a_replaced_transform_filters_with_its_own_rule_on_the_card(card):
    """The rule kept on a transform is not served to its ``replace()``d copy,
    and a lane seen before reads nothing more from the card to be lowered."""
    dyn, obs, makers = _rule_pairs(card)
    alg = makers["bsq_gh5"]()
    ys = torch.as_tensor(np.random.default_rng(3).normal(size=(64, 1, 10)), device=card)
    a = alg.forward_pass_batch(ys, engine="dd")
    rule = sf.lower_transform(alg.tf_dyn)
    alg.tf_dyn = alg.tf_dyn.replace(model_var=float(alg.tf_dyn.model_var) + 0.5)
    b = alg.forward_pass_batch(ys, engine="dd")
    assert sf.lower_transform(alg.tf_dyn) is not rule
    torch.testing.assert_close(b.pr_cov[..., 0] - a.pr_cov[..., 0],
                               torch.full((64, 1, 1), 0.5, dtype=torch.float64, device=card))


MUL_UT5 = np.hstack((np.zeros((5, 1), int), np.eye(5, dtype=int), 2 * np.eye(5, dtype=int)))
# (D, N, multi-index): the weight shapes of the BSQ studies, the verifiers'
# sample batch, a ragged total-degree basis and high exponents
VDM_SHAPES = {
    "ut1": (1, 3, np.array([[0, 1, 2]])),
    "gh7": (1, 7, np.atleast_2d(np.arange(7))),
    "ut5": (5, 11, MUL_UT5),
    "verifier": (5, 100_000, MUL_UT5),
    "td3_4": (3, 1001, None),
    "high": (2, 300, np.array([[9, 0, 3, 1], [2, 5, 0, 1]])),
    # the edges of a tile of 128 points, two column tiles, coordinates not in
    # registers, and multi-indices too large to travel by value (staged)
    "n1": (5, 1, MUL_UT5),
    "tile_short": (5, 127, MUL_UT5),
    "tile": (5, 128, MUL_UT5),
    "tile_over": (5, 129, MUL_UT5),
    "q40": (1, 1000, np.atleast_2d(np.arange(40) % 6)),
    "q33": (1, 257, np.atleast_2d(np.arange(33) % 4)),
    "even_q": (2, 5000, np.array([[0, 1, 2, 3], [3, 2, 1, 0]])),
    "d9": (9, 777, np.vstack((np.eye(9, dtype=int), [[2, 0, 1, 0, 3, 0, 0, 1, 2]])).T),
    "staged": (2, 10_001, np.arange(2 * 90).reshape(2, 90) % 5),
    "staged_big": (2, 300, np.ones((2, 6000), int)),
}


@pytest.mark.parametrize("name", sorted(VDM_SHAPES))
def test_vandermonde_kernel_matches_plain(card, name):
    from ssmtoybox_torch.ops import vandermonde as vdm
    from ssmtoybox_torch.utils.combin import total_degree_multi_index
    d, n, mul = VDM_SHAPES[name]
    mul = total_degree_multi_index(3, 4) if mul is None else mul
    x = torch.as_tensor(np.random.default_rng(n).normal(0.0, 1.7, size=(d, n)), device=card)
    before = vdm.LAUNCHES
    got = vdm.vandermonde(mul, x)
    assert vdm.LAUNCHES == before + 1
    want = vdm.vandermonde_plain(vdm._multi_index(mul, d), x)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and tuple(got.shape) == (n, mul.shape[1])
    assert torch.equal(got, want)
    # a small multi-index travels by value, nothing of it lies on the card;
    # a large one was copied there once, and a second call copies nothing
    copies = vdm._index(mul, d).on_card
    assert bool(copies) == (mul.size > vdm.VALUE_INTS)
    staged = copies.get(x.device)
    assert torch.equal(vdm.vandermonde(mul.copy(), x), want)
    assert vdm._index(mul, d).on_card.get(x.device) is staged


def test_vandermonde_kernel_refuses_what_it_does_not_take(card):
    from ssmtoybox_torch.ops import vandermonde as vdm
    before = vdm.LAUNCHES
    x = torch.zeros((2, 8), dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="negative"):
        vdm.vandermonde([[1, -1], [0, 1]], x)
    with pytest.raises(ValueError, match="contiguous"):
        vdm.vandermonde([[1, 2], [0, 1]], torch.zeros((8, 2), dtype=torch.float64,
                                                      device=card).T)
    with pytest.raises(ValueError, match="float64"):
        vdm.vandermonde([[1], [0]], x.float())
    with pytest.raises(ValueError, match="D <= 32"):
        vdm.vandermonde(np.ones((33, 1), int), torch.zeros((33, 2), dtype=torch.float64,
                                                          device=card))
    assert vdm.LAUNCHES == before


def test_bsq_weights_on_the_card_launch_the_kernel(card):
    """A BSQ transform built on the card launches the Vandermonde kernel and
    gives the CPU's weights (1e-12 relative; only the Cholesky and LU
    libraries differ)."""
    from ssmtoybox_torch.bq import BayesSardTransform
    from ssmtoybox_torch.ops import vandermonde as vdm
    par = np.array([[1.0, 1, 1, 1, 1, 1]])
    before = vdm.LAUNCHES
    tf = BayesSardTransform(5, 5, par, MUL_UT5, "ut", device=card)
    assert vdm.LAUNCHES >= before + 1
    ref = BayesSardTransform(5, 5, par, MUL_UT5, "ut", device="cpu")
    for key in ("wm", "Wc", "Wcc", "model_var"):
        a, b = getattr(tf, key).cpu(), getattr(ref, key)
        assert float((a - b).abs().max()) <= 1e-12 * max(float(b.abs().max()), 1e-300), key


# ---------------------------------------------------------------------------
# the vector filter kernel (ops/vector_filter.py, csrc/vector_filter.cu):
# bit-equal to its plain version, both on the card
# ---------------------------------------------------------------------------

def _vector_systems(device):
    """The reentry + radar system of ``bench.py`` and the CV radar system,
    each with a classical and a BQ filter, so that every instantiation of the
    launcher (model pair x kinds of both rules) runs."""
    from ssmtoybox_torch.ssmod import ConstantVelocity, Radar2DMeasurement, ReentryVehicle2DTransition
    re_dyn = ReentryVehicle2DTransition(
        GaussRV(5, mean=[6500.4, 349.14, -1.8093, -6.7967, 0.6932],
                cov=np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0]), device=device),
        GaussRV(3, cov=np.diag([2.4064e-5, 2.4064e-5, 1e-6]), device=device), dt=0.05)
    re_obs = Radar2DMeasurement(GaussRV(2, cov=np.diag([1e-3, 1e-5]), device=device),
                                dim_state=5, state_index=[0, 1], radar_loc=[6374.0, 0.0])
    cv_dyn = ConstantVelocity(GaussRV(4, mean=[10000.0, 300.0, 1000.0, -40.0],
                                      cov=np.diag([100.0, 25.0, 100.0, 25.0]), device=device),
                              GaussRV(2, cov=np.diag([50.0, 5.0]), device=device), dt=0.5)
    cv_obs = Radar2DMeasurement(GaussRV(2, cov=np.diag([50.0, 0.4e-6]), device=device),
                                dim_state=4, state_index=[0, 2])
    mul4 = np.hstack((np.zeros((4, 1), int), np.eye(4, dtype=int), 2 * np.eye(4, dtype=int)))
    cv_par = np.array([[1.0, 100.0, 100.0, 100.0, 100.0]])
    return {
        "reentry": (re_dyn, re_obs, stt.UnscentedKalman(re_dyn, re_obs),
                    stt.BayesSardKalman(re_dyn, re_obs, np.array([[1.0, 1, 1, 1, 1, 1]]),
                                        np.array([[1.0, 0.9, 0.9, 1e4, 1e4, 1e4]]), MUL_UT5,
                                        MUL_UT5)),
        "cv": (cv_dyn, cv_obs, stt.UnscentedKalman(cv_dyn, cv_obs),
               stt.BayesSardKalman(cv_dyn, cv_obs, cv_par, cv_par, mul4, mul4)),
    }


@pytest.mark.parametrize("batch", [1, 7, 4097, 10_000])
@pytest.mark.parametrize("kinds", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("system", ["reentry", "cv"])
def test_vector_kernel_matches_plain_at_every_instantiation(card, system, kinds, batch):
    """Every instantiation the launcher can pick, at batch sizes that leave
    the last warp and the last block ragged: the kernel equals its plain
    version to the bit over 20 steps, all five streams, and a second launch
    equals the first; time-major measurements are read through their strides."""
    from ssmtoybox_torch.ops import vector_filter as vf
    dyn, obs, classical, bq = _vector_systems(card)[system]
    rules = (classical, bq)
    params = vf.prepare(dyn, obs, rules[kinds[0]].tf_dyn, rules[kinds[1]].tf_obs)
    assert (params.dyn.kind, params.obs.kind) == kinds
    gen = torch.Generator(device=card).manual_seed(batch)
    x = dyn.simulate_discrete(gen, steps=20, mc_sims=batch)
    y = obs.simulate_measurements(gen, x).permute(2, 0, 1)       # (B, 2, 20), strided
    before = vf.LAUNCHES
    got = vf.vector_filter(params, y)
    assert vf.LAUNCHES == before + 1
    again = vf.vector_filter(params, y.contiguous())
    torch.cuda.synchronize()
    for s, g, r, g2 in zip(STREAMS, got, vf._vector_filter_plain(params, y), again):
        assert bool(torch.isfinite(g).all()), s
        assert torch.equal(g, r), f"{s}: {float((g - r).abs().max()):.3e}"
        assert torch.equal(g, g2), s


def test_the_card_is_the_default_device_of_the_vector_engine(card):
    """A reentry UKF built with no ``device`` argument filters through the
    vector kernel on the card."""
    from ssmtoybox_torch.ops import vector_filter as vf
    from ssmtoybox_torch.ssmod import Radar2DMeasurement, ReentryVehicle2DTransition
    stt.set_device(None)
    dyn = ReentryVehicle2DTransition(GaussRV(5, mean=[6500.4, 349.14, -1.8093, -6.7967, 0.6932],
                                             cov=np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0])),
                                     GaussRV(3, cov=np.diag([2.4064e-5, 2.4064e-5, 1e-6])))
    obs = Radar2DMeasurement(GaussRV(2, cov=np.diag([1e-3, 1e-5])), dim_state=5,
                             state_index=[0, 1], radar_loc=[6374.0, 0.0])
    before = vf.LAUNCHES
    res = stt.UnscentedKalman(dyn, obs).forward_pass_batch(
        np.tile([[[371.0], [1.22]]], (3, 1, 5)), engine="dd")
    assert vf.LAUNCHES == before + 1
    assert res.fi_mean.device.type == "cuda" and res.fi_cov.shape == (3, 5, 5, 5)


# ---------------------------------------------------------------------------
# the shaped kernel (csrc/vector_filter_shaped.cu): the UT and CKF shapes of
# both model pairs, bit-equal to the plain version; the first version keeps
# every other configuration
# ---------------------------------------------------------------------------

def _vector_case(card, system, rule, batch, steps=20):
    """Parameters of ``system`` under the named rule (both transforms, or
    ``"DYN/OBS"`` for a mixed pair) and ``batch`` simulated records."""
    from ssmtoybox_torch.ops import vector_filter as vf
    dyn, obs, classical, bq = _vector_systems(card)[system]
    algs = {"UKF": classical, "CKF": stt.CubatureKalman(dyn, obs), "BSQ-UT": bq}
    if system == "reentry":
        algs["GH-3"] = stt.GaussHermiteKalman(dyn, obs, deg=3)
        for points in ("ut", "sr"):
            algs[f"GPQ-{points.upper()}"] = stt.GaussianProcessKalman(dyn, obs, GPQ_RE_DYN,
                                                                     GPQ_RE_OBS, points=points)
    a, _, b = rule.partition("/")
    params = vf.prepare(dyn, obs, algs[a].tf_dyn, algs[b or a].tf_obs)
    gen = torch.Generator(device=card).manual_seed(batch)
    x = dyn.simulate_discrete(gen, steps=steps, mc_sims=batch)
    return params, obs.simulate_measurements(gen, x).permute(2, 0, 1)


def _same_bits(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("batch", [1, 7, 31, 4097, 10_000])
@pytest.mark.parametrize("rule", ["UKF", "CKF", "UKF/CKF", "CKF/UKF"])
@pytest.mark.parametrize("system", ["reentry", "cv"])
def test_vector_shaped_kernel_matches_plain(card, system, rule, batch):
    """The eight shapes of the shaped kernel on these two pairs (the UT and
    CKF counts on both transforms, and the two mixed) at batch sizes that
    leave the last warp and block ragged: equal to the plain version to the bit over 20
    steps, all five streams; a second launch equal to the first; both
    counters move by one."""
    from ssmtoybox_torch.ops import vector_filter as vf
    params, y = _vector_case(card, system, rule, batch)
    assert vf.kernel_of(params) == "vector_filter_shaped"
    before, shaped_before = vf.LAUNCHES, vf.SHAPED_LAUNCHES
    got = vf.vector_filter(params, y)
    assert (vf.LAUNCHES, vf.SHAPED_LAUNCHES) == (before + 1, shaped_before + 1)
    again = vf.vector_filter(params, y.contiguous())
    torch.cuda.synchronize()
    for s, g, r, g2 in zip(STREAMS, got, vf._vector_filter_plain(params, y), again):
        assert bool(torch.isfinite(g).all()), s
        assert torch.equal(g, r), f"{s}: {float((g - r).abs().max()):.3e}"
        assert torch.equal(g, g2), s


#: reentry GPQ kernel parameters (``chip_smoke.VF_GPQ_DYN`` / ``VF_GPQ_OBS``)
GPQ_RE_DYN = np.array([[1.0, 10, 10, 10, 10, 10]])
GPQ_RE_OBS = np.array([[1.0, 10, 10, 1e4, 1e4, 1e4]])
#: reentry rule -> the kernel ``kernel_of`` names: the UKF beside the CKF the
#: classical shaped kernel, GH-3 (243 points) the general kernel's warp form,
#: BQ rules and mixed kinds at the UT and CKF counts (one count on both, or
#: the two mixed) the BQ shapes
FIRST_OR_BQ = {"GH-3": "vector_filter_general", "UKF/CKF": "vector_filter_shaped",
               "GPQ-UT/CKF": "vector_filter_shaped_bq", "BSQ-UT": "vector_filter_shaped_bq",
               "UKF/BSQ-UT": "vector_filter_shaped_bq", "BSQ-UT/UKF": "vector_filter_shaped_bq"}


def _launch_counts(vf):
    return vf.LAUNCHES, vf.SHAPED_LAUNCHES, vf.BQ_SHAPED_LAUNCHES


@pytest.mark.parametrize("rule", ["GH-3", "BSQ-UT", "UKF/BSQ-UT", "BSQ-UT/UKF", "UKF/CKF",
                                  "GPQ-UT/CKF"])
def test_vector_first_version_keeps_the_other_shapes(card, monkeypatch, rule):
    """The UKF beside the CKF launches the classical shaped kernel, GH-3 the
    general kernel (its warp form); BQ rules and mixed kinds at one UT count,
    and a BQ rule beside the other count, the kernel of the BQ shapes; each
    equal to the plain version to the bit,
    counted on the kernel that ran.  Sent there by force, the first version
    still runs every one of them to the bit."""
    from ssmtoybox_torch.ops import vector_filter as vf
    params, y = _vector_case(card, "reentry", rule, 257)
    kernel = FIRST_OR_BQ[rule]
    assert vf.kernel_of(params) == kernel
    plain = vf._vector_filter_plain(params, y)
    before = _launch_counts(vf)
    got = vf.vector_filter(params, y)
    assert _launch_counts(vf) == (before[0] + 1, before[1] + int(kernel == "vector_filter_shaped"),
                                  before[2] + int(kernel == "vector_filter_shaped_bq"))
    monkeypatch.setattr(vf, "kernel_of", lambda p: "vector_filter")
    first = vf.vector_filter(params, y)
    torch.cuda.synchronize()
    for s, g, f, r in zip(STREAMS, got, first, plain):
        assert _same_bits(g, r), f"{s}: {float((g - r).nan_to_num().abs().max()):.3e}"
        assert _same_bits(f, r), f"first version, {s}"


#: (system, rule) of the BQ shapes: every model pair under a GPQ or BSQ rule at
#: N = 2 D + 1 or 2 D, and the mixed kinds of both counts
BQ_SHAPES = [("reentry", "GPQ-UT"), ("reentry", "BSQ-UT"), ("reentry", "GPQ-SR"),
             ("reentry", "UKF/BSQ-UT"), ("reentry", "BSQ-UT/UKF"), ("reentry", "CKF/GPQ-SR"),
             ("reentry", "GPQ-SR/CKF"), ("cv", "BSQ-UT"), ("cv", "UKF/BSQ-UT"),
             ("pendulum", "GPQ-SR"), ("falling_body", "GPQ-UT"), ("ct_bearing", "GPQ-UT"),
             ("reentry", "GPQ-UT/GPQ-SR"), ("reentry", "UKF/GPQ-SR"), ("reentry", "GPQ-UT/CKF"),
             ("reentry", "GPQ-SR/GPQ-UT"), ("reentry", "CKF/GPQ-UT"), ("reentry", "GPQ-SR/UKF"),
             ("cv", "BSQ-UT/CKF")]
#: GPQ kernel parameters of the zoo's pairs (``tests/test_torch_vector_filter_bq.py``)
GPQ_ZOO = {"pendulum": np.array([[1.0, 2.0, 2.0]]),
           "falling_body": np.array([[1.0, 3.0, 3.0, 3.0]]),
           "ct_bearing": np.array([[1.0, 3.0, 3.0, 3.0, 3.0, 3.0]])}


@pytest.mark.parametrize("system,rule", BQ_SHAPES)
def test_vector_bq_shapes_match_plain(card, system, rule):
    """The kernel of the BQ shapes at B = 257 (the last warp and block
    ragged): equal to the plain version to the bit over 20 steps, all five
    streams, a second launch equal to the first, counted once on
    ``BQ_SHAPED_LAUNCHES``."""
    from ssmtoybox_torch.ops import vector_filter as vf
    if system in GPQ_ZOO:
        dyn, obs = _zoo_systems(card)[system]
        par = GPQ_ZOO[system]
        gpq = stt.GaussianProcessKalman(dyn, obs, par, par, points=rule[-2:].lower())
        params = vf.prepare(dyn, obs, gpq.tf_dyn, gpq.tf_obs)
        y = _zoo_records(card, dyn, obs, 257)
    else:
        params, y = _vector_case(card, system, rule, 257)
    assert vf.kernel_of(params) == "vector_filter_shaped_bq"
    before = _launch_counts(vf)
    got = vf.vector_filter(params, y)
    assert _launch_counts(vf) == (before[0] + 1, before[1], before[2] + 1)
    again = vf.vector_filter(params, y.contiguous())
    torch.cuda.synchronize()
    for s, g, r, g2 in zip(STREAMS, got, vf._vector_filter_plain(params, y), again):
        assert bool(torch.isfinite(g).all()), s
        assert torch.equal(g, r), f"{s}: {float((g - r).abs().max()):.3e}"
        assert torch.equal(g, g2), s


def test_a_failed_bq_shaped_launch_raises(card, monkeypatch):
    """Two classical rules at mixed counts (the classical shaped kernel's
    shape) sent to the kernel of the BQ shapes by force: its launcher
    refuses them (its mixed counts all hold a BQ rule), the wrapper raises,
    counts nothing and falls back to nothing."""
    from ssmtoybox_torch.ops import vector_filter as vf
    params, y = _vector_case(card, "reentry", "UKF/CKF", 7)
    monkeypatch.setattr(vf, "kernel_of", lambda p: "vector_filter_shaped_bq")
    before = _launch_counts(vf)
    with pytest.raises(RuntimeError, match="vector_filter_shaped_bq kernel launch failed"):
        vf.vector_filter(params, y)
    assert _launch_counts(vf) == before


def test_a_failed_shaped_launch_raises(card, monkeypatch):
    """A configuration the shaped kernel's launcher refuses (CT with the
    radar, a model pair it does not instantiate, under the UKF, routed to it
    by force) raises, counts nothing and falls back to nothing."""
    from ssmtoybox_torch.ops import vector_filter as vf
    dyn, obs = _general_systems(card)["ct_radar"]
    ukf = stt.UnscentedKalman(dyn, obs)
    params = vf.prepare(dyn, obs, ukf.tf_dyn, ukf.tf_obs)
    y = _zoo_records(card, dyn, obs, 7)
    monkeypatch.setattr(vf, "kernel_of", lambda p: "vector_filter_shaped")
    before, shaped_before = vf.LAUNCHES, vf.SHAPED_LAUNCHES
    with pytest.raises(RuntimeError, match="vector_filter_shaped kernel launch failed"):
        vf.vector_filter(params, y)
    assert (vf.LAUNCHES, vf.SHAPED_LAUNCHES) == (before, shaped_before)


def test_the_shaped_kernel_fills_a_failed_trajectory_with_nan(card):
    """A covariance that is not positive definite gives NaN in every stream
    from that step on, as in the plain version."""
    from ssmtoybox_torch.ops import vector_filter as vf
    dyn, obs, ukf, _ = _vector_systems(card)["reentry"]
    params = vf.prepare(dyn, obs, ukf.tf_dyn, ukf.tf_obs, init_cov=-np.eye(5))
    _, y = _vector_case(card, "reentry", "UKF", 33)
    got = vf.vector_filter(params, y)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[0]).all())
    for s, g, r in zip(STREAMS, got, vf._vector_filter_plain(params, y)):
        assert _same_bits(g, r), s


# ---------------------------------------------------------------------------
# the zoo's model pairs in both vector filter kernels: the pendulum, the
# falling body with its range and the coordinated turn with four bearings
# ---------------------------------------------------------------------------

def _zoo_systems(device):
    """(dynamics, measurement) of the configurations of
    ``tests/test_ddvec.py:262-289``."""
    from ssmtoybox_torch.ssmod import (BearingMeasurement, CoordinatedTurnTransition,
                                       Pendulum2DMeasurement, Pendulum2DTransition,
                                       RangeMeasurement, ReentryVehicle1DTransition)
    dt = 0.01
    q = 0.1 * np.array([[dt ** 3 / 3, dt ** 2 / 2], [dt ** 2 / 2, dt]])
    sensors = np.array([[0.0, 0.0], [200.0, 0.0], [0.0, 200.0], [200.0, 200.0]])
    return {
        "pendulum": (Pendulum2DTransition(GaussRV(2, mean=[1.5, 0.0], cov=0.01 * np.eye(2),
                                                  device=device),
                                          GaussRV(2, cov=q, device=device), dt=dt),
                     Pendulum2DMeasurement(GaussRV(1, cov=0.1, device=device), dim_state=2)),
        "falling_body": (ReentryVehicle1DTransition(
                             GaussRV(3, mean=[90.0, 6.0, 1.5], cov=0.09 * np.eye(3), device=device),
                             GaussRV(3, cov=1e-8 * np.eye(3), device=device), dt=0.1),
                         RangeMeasurement(GaussRV(1, cov=0.03, device=device), dim_state=3)),
        "ct_bearing": (CoordinatedTurnTransition(
                           GaussRV(5, mean=[100.0, 10.0, 100.0, 5.0, 0.06],
                                   cov=np.diag([10.0, 1.0, 10.0, 1.0, 1e-3]), device=device),
                           GaussRV(5, cov=np.diag([0.1, 0.1, 0.1, 0.1, 1e-5]), device=device),
                           dt=0.1),
                       BearingMeasurement(GaussRV(4, cov=1e-3 * np.eye(4), device=device),
                                          dim_state=5, state_index=[0, 2], sensor_pos=sensors)),
    }


def _zoo_records(card, dyn, obs, batch):
    gen = torch.Generator(device=card).manual_seed(batch)
    x = dyn.simulate_discrete(gen, steps=20, mc_sims=batch)
    return obs.simulate_measurements(gen, x).permute(2, 0, 1)              # strided


@pytest.mark.parametrize("batch", [1, 7, 31, 257])
@pytest.mark.parametrize("kernel", ["vector_filter_shaped", "vector_filter"])
@pytest.mark.parametrize("rule", ["UKF", "CKF"])
@pytest.mark.parametrize("system", ["pendulum", "falling_body", "ct_bearing"])
def test_zoo_pairs_match_plain_in_both_vector_kernels(card, monkeypatch, system, rule, kernel,
                                                      batch):
    """Each new model pair under UKF and CKF rules, in the shaped kernel and
    (sent there by force) the first version: equal to the plain version to
    the bit over 20 steps, all five streams, a second launch equal to the
    first, the launch counted on the kernel that ran."""
    from ssmtoybox_torch.ops import vector_filter as vf
    dyn, obs = _zoo_systems(card)[system]
    alg = (stt.UnscentedKalman if rule == "UKF" else stt.CubatureKalman)(dyn, obs)
    params = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    assert vf.kernel_of(params) == "vector_filter_shaped"
    monkeypatch.setattr(vf, "kernel_of", lambda p: kernel)
    y = _zoo_records(card, dyn, obs, batch)
    before, shaped_before = vf.LAUNCHES, vf.SHAPED_LAUNCHES
    got = vf.vector_filter(params, y)
    assert (vf.LAUNCHES - before, vf.SHAPED_LAUNCHES - shaped_before) == (
        1, int(kernel == "vector_filter_shaped"))
    again = vf.vector_filter(params, y.contiguous())
    torch.cuda.synchronize()
    for s, g, r, g2 in zip(STREAMS, got, vf._vector_filter_plain(params, y), again):
        assert bool(torch.isfinite(g).all()), s
        assert torch.equal(g, r), f"{s}: {float((g - r).abs().max()):.3e}"
        assert torch.equal(g, g2), s


def test_zoo_bq_rule_runs_in_the_first_version(card, monkeypatch):
    """The pendulum's GPQ filter of the goldens (spherical-radial points, N =
    2 D) launches the kernel of the BQ shapes, and, sent there by force, the
    first version; both equal to the plain version to the bit."""
    from ssmtoybox_torch.ops import vector_filter as vf
    dyn, obs = _zoo_systems(card)["pendulum"]
    par = np.array([[1.0, 2.0, 2.0]])
    gpq = stt.GaussianProcessKalman(dyn, obs, par, par, points="sr")
    params = vf.prepare(dyn, obs, gpq.tf_dyn, gpq.tf_obs)
    assert vf.kernel_of(params) == "vector_filter_shaped_bq"
    y = _zoo_records(card, dyn, obs, 257)
    plain = vf._vector_filter_plain(params, y)
    before = _launch_counts(vf)
    got = vf.vector_filter(params, y)
    assert _launch_counts(vf) == (before[0] + 1, before[1], before[2] + 1)
    monkeypatch.setattr(vf, "kernel_of", lambda p: "vector_filter")
    first = vf.vector_filter(params, y)
    assert _launch_counts(vf) == (before[0] + 2, before[1], before[2] + 1)
    torch.cuda.synchronize()
    for s, g, f, r in zip(STREAMS, got, first, plain):
        assert _same_bits(g, r), f"{s}: {float((g - r).nan_to_num().abs().max()):.3e}"
        assert _same_bits(f, r), f"first version, {s}"


def test_parallel_smoother_outputs_lie_on_the_card(card):
    """``iterated_parallel_smoother`` on models built with no device
    argument (the card) and a measurement record on the card: every output
    on the card, float32 in square-root mode, finite."""
    from ssmtoybox_torch.parallel import iterated_parallel_smoother
    from ssmtoybox_torch.ssmod import Pendulum2DMeasurement, Pendulum2DTransition
    dt = 0.01
    q = 0.1 * np.array([[dt ** 3 / 3, dt ** 2 / 2], [dt ** 2 / 2, dt]])
    dyn = Pendulum2DTransition(GaussRV(2, mean=[1.5, 0.0], cov=0.01 * np.eye(2)),
                               GaussRV(2, cov=q), dt=dt)
    obs = Pendulum2DMeasurement(GaussRV(1, cov=0.1), dim_state=2)
    gen = torch.Generator(device=card).manual_seed(0)
    y = obs.simulate_measurements(gen, dyn.simulate_discrete(gen, steps=300))[..., 0]
    ut = stt.UnscentedTransform(2)
    for kw in (dict(), dict(sqrt=True, dtype=torch.float32, chol_jitter=1e-7)):
        res = iterated_parallel_smoother(dyn, obs, ut, ut, y, iterations=2, **kw)
        for f in ("fi_mean", "fi_cov", "sm_mean", "sm_cov"):
            t = getattr(res, f)
            assert t.device.type == "cuda", f
            assert t.dtype == kw.get("dtype", torch.float64), f
            assert bool(torch.isfinite(t).all()), f


def test_parallel_scans_and_fit_lie_on_the_card(card):
    """The linear scans on arrays (they go to the default device, the card)
    and the batched NLML fit on a GP model built with no device argument."""
    from ssmtoybox_torch.bq.models import GaussianProcessModel
    from ssmtoybox_torch.parallel import (fit_kernel_params, parallel_linear_sqrt_filter,
                                          parallel_linear_sqrt_smoother)
    rng = np.random.default_rng(0)
    F, SQ = np.array([[1.0, 0.5], [0.0, 1.0]]), 0.1 * np.eye(2)
    fm, fS = parallel_linear_sqrt_filter(F, SQ, np.eye(2)[:1], np.eye(1), np.zeros(2), np.eye(2),
                                         rng.standard_normal((1, 100)), scan_block_len=32)
    sm, sS = parallel_linear_sqrt_smoother(F, SQ, fm, fS)
    assert all(t.device.type == "cuda" for t in (fm, fS, sm, sS))
    gp = GaussianProcessModel(1, KERN_PAR, "rbf", "ut")
    fo = torch.sin(gp.points.T + torch.linspace(0.0, 1.0, 64, device=card)[:, None, None])
    lp, losses = fit_kernel_params(gp, np.zeros(2), fo, gp.points, num_steps=5)
    assert lp.device.type == "cuda" and losses.device.type == "cuda"
    assert float(losses[-1]) < float(losses[0])


def _general_systems(device):
    """Model pairs that only the general vector kernel takes."""
    from ssmtoybox_torch.ssmod import (BearingMeasurement, CoordinatedTurnTransition,
                                       Pendulum2DTransition, Radar2DMeasurement,
                                       ReentryVehicle1DTransition)
    sensors = [[0.0, 0.0], [200.0, 0.0], [0.0, 200.0], [200.0, 200.0], [100.0, 0.0],
               [0.0, 100.0]]

    def ct():
        return CoordinatedTurnTransition(
            GaussRV(5, mean=[100.0, 10.0, 100.0, 5.0, 0.06],
                    cov=np.diag([10.0, 1.0, 10.0, 1.0, 1e-3]), device=device),
            GaussRV(5, cov=np.diag([0.1, 0.1, 0.1, 0.1, 1e-5]), device=device), dt=0.1)

    dt = 0.01
    q = 0.1 * np.array([[dt ** 3 / 3, dt ** 2 / 2], [dt ** 2 / 2, dt]])
    return {
        "ct_radar": (ct(), Radar2DMeasurement(GaussRV(2, cov=np.diag([1.0, 1e-4]), device=device),
                                              dim_state=5, state_index=[0, 2])),
        "ct_bearing3": (ct(), BearingMeasurement(GaussRV(3, cov=1e-3 * np.eye(3), device=device),
                                                 dim_state=5, state_index=[0, 2],
                                                 sensor_pos=sensors[:3])),
        "pendulum_ungm": (Pendulum2DTransition(GaussRV(2, mean=[1.5, 0.0], cov=0.01 * np.eye(2),
                                                       device=device),
                                               GaussRV(2, cov=q, device=device), dt=dt),
                          UNGMMeasurement(GaussRV(1, cov=0.1, device=device), dim_state=2,
                                          state_index=[0])),
        "falling_body_bearing6": (ReentryVehicle1DTransition(
                                      GaussRV(3, mean=[90.0, 6.0, 1.5], cov=0.09 * np.eye(3),
                                              device=device),
                                      GaussRV(3, cov=1e-8 * np.eye(3), device=device), dt=0.1),
                                  BearingMeasurement(GaussRV(6, cov=1e-3 * np.eye(6),
                                                             device=device),
                                                     dim_state=3, sensor_pos=sensors)),
    }


@pytest.mark.parametrize("batch", [1, 7, 257])
@pytest.mark.parametrize("rule", ["UKF", "CKF"])
@pytest.mark.parametrize("system", ["ct_radar", "ct_bearing3", "pendulum_ungm",
                                    "falling_body_bearing6"])
def test_general_vector_kernel_matches_plain(card, system, rule, batch):
    """A pair that only the general vector kernel takes: one launch of it,
    counted on it, equal to the plain version to the bit over 20 steps, a
    second launch equal to the first."""
    from ssmtoybox_torch.ops import vector_filter as vf
    dyn, obs = _general_systems(card)[system]
    alg = (stt.UnscentedKalman if rule == "UKF" else stt.CubatureKalman)(dyn, obs)
    params = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    assert vf.kernel_of(params) == "vector_filter_general"
    y = _zoo_records(card, dyn, obs, batch)
    before, general_before = vf.LAUNCHES, vf.GENERAL_LAUNCHES
    got = vf.vector_filter(params, y)
    assert (vf.LAUNCHES - before, vf.GENERAL_LAUNCHES - general_before) == (1, 1)
    again = vf.vector_filter(params, y.contiguous())
    torch.cuda.synchronize()
    for s, g, r, g2 in zip(STREAMS, got, vf._vector_filter_plain(params, y), again):
        assert bool(torch.isfinite(g).all()), s
        assert torch.equal(g, r), f"{s}: {float((g - r).abs().max()):.3e}"
        assert torch.equal(g, g2), s


@pytest.mark.parametrize("rule", ["gh9", "gh15", "gpq_gh15", "range_ukf", "sine_ukf"])
def test_general_scalar_form_matches_plain(card, rule):
    """The scalar kernel's general form (rules of more than 8 points, the
    range and sine measurements): one launch, counted as a general one,
    equal to the plain version to the bit over 40 steps."""
    from ssmtoybox_torch.ssmod import Pendulum2DMeasurement, RangeMeasurement
    dyn = UNGMTransition(GaussRV(1, cov=5.0, device=card), GaussRV(1, cov=10.0, device=card))
    obs = {"range_ukf": RangeMeasurement(GaussRV(1, cov=0.03, device=card), dim_state=1),
           "sine_ukf": Pendulum2DMeasurement(GaussRV(1, cov=0.1, device=card), dim_state=1)}.get(
        rule, UNGMMeasurement(GaussRV(1, cov=1.0, device=card), dim_state=1))
    alg = {"gh9": lambda: stt.GaussHermiteKalman(dyn, obs, deg=9),
           "gh15": lambda: stt.GaussHermiteKalman(dyn, obs, deg=15),
           "gpq_gh15": lambda: stt.GaussianProcessKalman(dyn, obs, KERN_PAR, KERN_PAR, points="gh",
                                                         point_hyp={"degree": 15})}.get(
        rule, lambda: stt.UnscentedKalman(dyn, obs))()
    params = sf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    assert sf.form_of(params) == "general"
    gen = torch.Generator(device=card).manual_seed(7)
    x = dyn.simulate_discrete(gen, steps=40, mc_sims=4097)
    y = obs.simulate_measurements(gen, x)[0].contiguous()
    c = torch.as_tensor(sf.ungm_consts(40), device=card)
    before = (sf.LAUNCHES, sf.GENERAL_LAUNCHES)
    got = sf.scalar_filter(params, y, c)
    assert (sf.LAUNCHES - before[0], sf.GENERAL_LAUNCHES - before[1]) == (1, 1)
    torch.cuda.synchronize()
    for s, g, r in zip(STREAMS, got, sf._scalar_filter_plain(params, y, c)):
        assert bool(torch.isfinite(g).all()), s
        assert torch.equal(g, r), f"{s}: {float((g - r).abs().max()):.3e}"


@pytest.mark.parametrize("sensors", [9, 16])
def test_general_vector_kernel_takes_any_bearing_count(card, sensors):
    """CT with bearings from more than 8 sensors: the general kernel's wide
    form, one launch counted on it, equal to the plain version to the bit
    over 20 steps, a second launch equal to the first."""
    from ssmtoybox_torch.ops import vector_filter as vf
    from ssmtoybox_torch.ssmod import BearingMeasurement
    dyn = _general_systems(card)["ct_radar"][0]
    pos = [[100.0 + 150.0 * np.cos(0.2 + 2 * np.pi * i / 16),
            100.0 + 150.0 * np.sin(0.2 + 2 * np.pi * i / 16)] for i in range(sensors)]
    obs = BearingMeasurement(GaussRV(sensors, cov=1e-3 * np.eye(sensors), device=card),
                             dim_state=5, state_index=[0, 2], sensor_pos=pos)
    alg = stt.CubatureKalman(dyn, obs)
    params = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    assert vf.kernel_of(params) == "vector_filter_general"
    y = _zoo_records(card, dyn, obs, 257)
    before = (vf.LAUNCHES, vf.GENERAL_LAUNCHES)
    got = vf.vector_filter(params, y)
    assert (vf.LAUNCHES - before[0], vf.GENERAL_LAUNCHES - before[1]) == (1, 1)
    again = vf.vector_filter(params, y)
    torch.cuda.synchronize()
    for s, g, r, g2 in zip(STREAMS, got, vf._vector_filter_plain(params, y), again):
        assert bool(torch.isfinite(g).all()), s
        assert torch.equal(g, r), f"{s}: {float((g - r).abs().max()):.3e}"
        assert torch.equal(g, g2), s


# ---------------------------------------------------------------------------
# models registered at run time (ops.register_*): the registered vector
# kernel (csrc/vector_filter_registered.cu) and the scalar kernel's
# registered form (csrc/scalar_filter_registered.cu), built from headers
# generated from the forms
# ---------------------------------------------------------------------------

class _Driven(stt.ssmod.TransitionModel):
    """A driven pendulum: ``[x0 + dt x1, x1 - w dt sin(x0) + dt u_t]``."""
    dim_state, dim_noise = 2, 2
    DT, W = 0.05, 4.0

    def dyn_fcn(self, x, q, time):
        x0, x1 = x.unbind(-1)
        u = 0.5 * float(np.sin(0.1 * time))
        return torch.stack([x0 + self.DT * x1,
                            x1 - (self.W * self.DT) * torch.sin(x0) + self.DT * u], -1) + q


class _Growth(stt.ssmod.TransitionModel):
    """``0.5 x + 5 x / (1 + x^2) + 2 cos(0.7 t)``."""
    dim_state, dim_noise = 1, 1

    def dyn_fcn(self, x, q, time):
        return 0.5 * x + 5.0 * (x / (1.0 + x * x)) + 2.0 * float(np.cos(0.7 * time)) + q


class _PendulumCopy(stt.ssmod.Pendulum2DTransition):
    pass


def _driven_lower(model, n_steps):
    from ssmtoybox_torch.ops import KernelForm

    def plain(x, c, s, fns):
        x0, x1 = x.unbind(-1)
        return torch.stack([x0 + c[0] * x1, x1 - c[1] * fns.sin(x0) + c[0] * s[0]], -1)
    return [0.5 * np.sin(0.1 * np.arange(n_steps))], KernelForm(
        "f[0] = x[0] + c[0] * x[1];\nf[1] = x[1] - c[1] * sin(x[0]) + c[0] * s[0];",
        (model.DT, model.W * model.DT), plain)


def _pendulum_lower(model, n_steps):
    from ssmtoybox_torch.ops import KernelForm

    def plain(x, c, s, fns):
        x0, x1 = x.unbind(-1)
        return torch.stack([x0 + x1 * c[0], x1 - c[1] * fns.sin(x0)], -1)
    return [], KernelForm("f[0] = x[0] + x[1] * c[0];\nf[1] = x[1] - c[1] * sin(x[0]);",
                          (model.dt, model.g * model.dt), plain)


@pytest.fixture
def registered():
    """The models above registered in the port, unregistered afterwards."""
    from ssmtoybox_torch.ops import (KernelForm, forms, register_dyn_dd, register_dyn_dd_vec)
    register_dyn_dd_vec(_Driven, _driven_lower)
    register_dyn_dd_vec(_PendulumCopy, _pendulum_lower)
    register_dyn_dd(_Growth, lambda m, n: 2.0 * np.cos(0.7 * np.arange(n)), KernelForm(
        "f[0] = 0.5 * x[0] + 5.0 * (x[0] / (1.0 + x[0] * x[0])) + s[0];", (),
        lambda x, c, s, fns: 0.5 * x + 5.0 * (x / (1.0 + x * x)) + s[0]))
    yield
    for reg, cls in ((forms.DYN_DD_VEC, _Driven), (forms.DYN_DD_VEC, _PendulumCopy),
                     (forms.DYN_DD, _Growth)):
        reg.pop(cls, None)


def _radar(card, D):
    from ssmtoybox_torch.ssmod import Radar2DMeasurement
    return Radar2DMeasurement(GaussRV(2, cov=np.diag([0.01, 1e-3]), device=card), dim_state=D,
                              state_index=[0, 1], radar_loc=np.array([-2.0, -2.0]))


@pytest.mark.parametrize("rule", ["UKF", "GH-3"])
def test_registered_vector_kernel_matches_plain(card, registered, rule):
    """A registered transition with a per-step stream and the table's radar
    through ``engine="dd"``: one launch of the registered kernel, equal to
    the plain version to the bit over 20 steps."""
    from ssmtoybox_torch.ops import vector_filter as vf
    dyn = _Driven(GaussRV(2, mean=[1.0, 0.0], cov=0.1 * np.eye(2), device=card),
                  GaussRV(2, cov=1e-3 * np.eye(2), device=card))
    obs = _radar(card, 2)
    alg = (stt.UnscentedKalman(dyn, obs) if rule == "UKF"
           else stt.GaussHermiteKalman(dyn, obs, deg=3))
    params = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    assert vf.kernel_of(params) == "vector_filter_registered"
    y = _zoo_records(card, dyn, obs, 4097)
    before = (vf.LAUNCHES, vf.REGISTERED_LAUNCHES)
    res = alg.forward_pass_batch(y, engine="dd")
    assert (vf.LAUNCHES - before[0], vf.REGISTERED_LAUNCHES - before[1]) == (1, 1)
    torch.cuda.synchronize()
    plain = vf._vector_filter_plain(params, y)
    for f, r in zip(("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov"), plain):
        g = getattr(res, f)
        g = g.permute(2, 1, 0) if g.ndim == 3 else g.permute(3, 1, 2, 0)
        assert bool(torch.isfinite(g).all()), f
        assert torch.equal(g, r), f"{f}: {float((g - r).abs().max()):.3e}"


def test_registered_pendulum_copy_equals_the_tables_pendulum(card, registered):
    """The pendulum registered with the statements of the table's form runs
    in the registered kernel and gives the general kernel's bits."""
    from ssmtoybox_torch.ops import vector_filter as vf
    from ssmtoybox_torch.ssmod import Pendulum2DTransition
    out = []
    for cls in (_PendulumCopy, Pendulum2DTransition):
        dyn = cls(GaussRV(2, mean=[1.5, 0.0], cov=0.01 * np.eye(2), device=card),
                  GaussRV(2, cov=1e-4 * np.eye(2), device=card), dt=0.01)
        alg = stt.UnscentedKalman(dyn, _radar(card, 2))
        params = vf.prepare(dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
        if not out:
            y = _zoo_records(card, dyn, alg.mod_obs, 1000)
        out.append((vf.kernel_of(params), vf.vector_filter(params, y)))
    torch.cuda.synchronize()
    assert [k for k, _ in out] == ["vector_filter_registered", "vector_filter_general"]
    for s, a, b in zip(STREAMS, out[0][1], out[1][1]):
        assert torch.equal(a, b), s


def test_registered_scalar_form_matches_plain(card, registered):
    """A 1-D transition of the scalar registry with the UNGM measurement: the
    scalar kernel's registered form, one launch counted on it, equal to the
    plain version to the bit over 40 steps."""
    dyn = _Growth(GaussRV(1, cov=1.0, device=card), GaussRV(1, cov=1.0, device=card))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0, device=card), dim_state=1)
    alg = stt.UnscentedKalman(dyn, obs)
    params = sf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    assert sf.form_of(params) == "registered"
    gen = torch.Generator(device=card).manual_seed(8)
    x = dyn.simulate_discrete(gen, steps=40, mc_sims=4097)
    y = obs.simulate_measurements(gen, x)[0].contiguous()
    c = sf.step_consts(params, 40, card)
    before = (sf.LAUNCHES, sf.REGISTERED_LAUNCHES)
    got = sf.scalar_filter(params, y, c)
    assert (sf.LAUNCHES - before[0], sf.REGISTERED_LAUNCHES - before[1]) == (1, 1)
    torch.cuda.synchronize()
    for s, g, r in zip(STREAMS, got, sf._scalar_filter_plain(params, y, c)):
        assert bool(torch.isfinite(g).all()), s
        assert torch.equal(g, r), f"{s}: {float((g - r).abs().max()):.3e}"


def test_a_registered_form_that_does_not_build_raises(card, registered):
    """A form whose statements do not compile: ``engine="auto"`` still takes
    the fused route (admission decides it, not the build) and raises with
    the compiler's output; nothing falls back to the eager filter."""
    from ssmtoybox_torch.ops import KernelForm, register_dyn_dd_vec

    def broken(model, n_steps):
        streams, form = _driven_lower(model, n_steps)
        return streams, KernelForm("f[0] = x[0] +;", (), form.plain)
    register_dyn_dd_vec(_Driven, broken)
    dyn = _Driven(GaussRV(2, mean=[1.0, 0.0], cov=0.1 * np.eye(2), device=card),
                  GaussRV(2, cov=1e-3 * np.eye(2), device=card))
    alg = stt.UnscentedKalman(dyn, _radar(card, 2))
    y = torch.zeros((3, 2, 5), dtype=torch.float64, device=card)
    with pytest.raises(RuntimeError, match="building vector_filter_registered.*failed"):
        alg.forward_pass_batch(y, engine="auto")


# ---------------------------------------------------------------------------
# the lane-group form of the general and registered kernels
# (csrc/vector_filter_lanes.cuh): more than 4 outputs, or a registered state
# of more than 5 dimensions
# ---------------------------------------------------------------------------

def _ct_bearings(card, sensors):
    from ssmtoybox_torch.ssmod import BearingMeasurement
    dyn = _general_systems(card)["ct_radar"][0]
    pos = [[100.0 + 150.0 * np.cos(0.2 + 2 * np.pi * i / 16),
            100.0 + 150.0 * np.sin(0.2 + 2 * np.pi * i / 16)] for i in range(sensors)]
    return dyn, BearingMeasurement(GaussRV(sensors, cov=1e-3 * np.eye(sensors), device=card),
                                   dim_state=5, state_index=[0, 2], sensor_pos=pos)


def _forced(card, vf, params, y, lanes):
    """The general kernel launched on ``lanes`` lanes a trajectory (0: one
    thread) through its C entry point; the five streams."""
    import ctypes
    B, _, T = y.shape
    out = vf._empty_streams(params.dim_state, T, B, card)
    scratch = vf._scratch(params, B, card, lanes)
    rc = vf.build().vfg_launch(ctypes.byref(vf._c_general(params, card)), y.data_ptr(),
                               *y.stride(), B, T, card.index or 0, *(o.data_ptr() for o in out),
                               scratch.data_ptr(), lanes,
                               torch.cuda.current_stream(card).cuda_stream)
    assert rc == 0
    return out


@pytest.mark.parametrize("rule", ["CKF", "GPQ"])
@pytest.mark.parametrize("sensors", [5, 8, 16])
def test_lane_form_matches_plain(card, sensors, rule):
    """CT with more than 4 bearings: the wrapper launches the general
    kernel's lane-group form once, counted on it, equal to the plain version
    to the bit over 20 steps; the one-thread form, by force, gives the same
    bits."""
    from ssmtoybox_torch.ops import vector_filter as vf
    dyn, obs = _ct_bearings(card, sensors)
    par = np.array([[1.0] + [3.0] * 5])
    alg = (stt.CubatureKalman(dyn, obs) if rule == "CKF"
           else stt.GaussianProcessKalman(dyn, obs, par, par))
    params = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_general", vf._LANES)
    y = _zoo_records(card, dyn, obs, 257)
    before = (vf.LAUNCHES, vf.GENERAL_LAUNCHES, vf.GENERAL_LANE_LAUNCHES)
    got = vf.vector_filter(params, y)
    assert (vf.LAUNCHES - before[0], vf.GENERAL_LAUNCHES - before[1],
            vf.GENERAL_LANE_LAUNCHES - before[2]) == (1, 1, 1)
    others = [_forced(card, vf, params, y, 0)]
    torch.cuda.synchronize()
    for i, (s, r) in enumerate(zip(STREAMS, vf._vector_filter_plain(params, y))):
        assert bool(torch.isfinite(got[i]).all()), s
        assert torch.equal(got[i], r), f"{s}: {float((got[i] - r).abs().max()):.3e}"
        for other in others:
            assert torch.equal(other[i], r), s


class _Chain8D(stt.ssmod.TransitionModel):
    """Four coupled pendulums, 8 states."""
    dim_state, dim_noise = 8, 8
    DT, W, K = 0.05, 2.0, 0.5

    def dyn_fcn(self, x, q, time):
        p, v = x[..., 0::2], x[..., 1::2]
        nxt = torch.roll(p, -1, dims=-1)
        f = torch.stack([p + self.DT * v,
                         v - self.DT * (self.W * torch.sin(p) - self.K * (nxt - p))], -1)
        return f.reshape(x.shape) + q


def _chain_lower(model, n_steps):
    from ssmtoybox_torch.ops import KernelForm
    lines = []
    for i in range(4):
        p, v, nxt = 2 * i, 2 * i + 1, 2 * ((i + 1) % 4)
        lines += [f"f[{p}] = x[{p}] + c[0] * x[{v}];",
                  f"f[{v}] = x[{v}] - c[0] * (c[1] * sin(x[{p}]) - c[2] * (x[{nxt}] - x[{p}]));"]

    def plain(x, c, s, fns):
        p, v = x[..., 0::2], x[..., 1::2]
        nxt = torch.roll(p, -1, dims=-1)
        f = torch.stack([p + c[0] * v, v - c[0] * (c[1] * fns.sin(p) - c[2] * (nxt - p))], -1)
        return f.reshape(x.shape)
    return [], KernelForm("\n".join(lines), (model.DT, model.W, model.K), plain)


def test_registered_lane_form_matches_plain(card):
    """A registered 8-D transition with the table's radar through
    ``engine="dd"``: one launch of the registered kernel's lane-group form,
    counted on it, equal to the plain version to the bit over 20 steps."""
    from ssmtoybox_torch.ops import forms, register_dyn_dd_vec, vector_filter as vf
    register_dyn_dd_vec(_Chain8D, _chain_lower)
    try:
        dyn = _Chain8D(GaussRV(8, mean=np.tile([0.5, 0.0], 4), cov=0.05 * np.eye(8), device=card),
                       GaussRV(8, cov=1e-4 * np.eye(8), device=card))
        alg = stt.CubatureKalman(dyn, _radar(card, 8))
        params = vf.prepare(dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
        assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_registered",
                                                               vf._LANES)
        y = _zoo_records(card, dyn, alg.mod_obs, 1000)
        before = (vf.REGISTERED_LAUNCHES, vf.REGISTERED_LANE_LAUNCHES)
        res = alg.forward_pass_batch(y, engine="dd")
        assert (vf.REGISTERED_LAUNCHES - before[0],
                vf.REGISTERED_LANE_LAUNCHES - before[1]) == (1, 1)
        torch.cuda.synchronize()
        for f, r in zip(("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov"),
                        vf._vector_filter_plain(params, y)):
            g = getattr(res, f)
            g = g.permute(2, 1, 0) if g.ndim == 3 else g.permute(3, 1, 2, 0)
            assert bool(torch.isfinite(g).all()), f
            assert torch.equal(g, r), f"{f}: {float((g - r).abs().max()):.3e}"
    finally:
        forms.DYN_DD_VEC.pop(_Chain8D, None)


# ---------------------------------------------------------------------------
# the warp form of the general and registered kernels (a trajectory on a
# whole warp, csrc/vector_filter_lanes.cuh): rules of many points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 4097])
@pytest.mark.parametrize("system", ["reentry", "ct_bearings8"])
def test_warp_form_matches_plain(card, monkeypatch, system, batch):
    """GH-3 (243 points) on the reentry bench lane and on CT with 8
    bearings: the wrapper launches the general kernel's warp form once,
    counted on it, equal to the plain version to the bit over 20 steps (4,097
    trajectories leave the last block of 16 warps one warp); the first
    version (reentry) or the one-thread form (CT), by force, gives the same
    bits."""
    from ssmtoybox_torch.ops import vector_filter as vf
    if system == "reentry":
        params, y = _vector_case(card, "reentry", "GH-3", batch)
    else:
        dyn, obs = _ct_bearings(card, 8)
        alg = stt.GaussHermiteKalman(dyn, obs, deg=3)
        params, y = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs), _zoo_records(card, dyn, obs,
                                                                               batch)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_general", vf._WARP)
    before = (vf.LAUNCHES, vf.GENERAL_LAUNCHES, vf.GENERAL_WARP_LAUNCHES)
    got = vf.vector_filter(params, y)
    assert (vf.LAUNCHES - before[0], vf.GENERAL_LAUNCHES - before[1],
            vf.GENERAL_WARP_LAUNCHES - before[2]) == (1, 1, 1)
    if system == "reentry":
        monkeypatch.setattr(vf, "kernel_of", lambda p: "vector_filter")
        other = vf.vector_filter(params, y)
    else:
        other = _forced(card, vf, params, y, 0)
    torch.cuda.synchronize()
    for s, g, o, r in zip(STREAMS, got, other, vf._vector_filter_plain(params, y)):
        assert bool(torch.isfinite(g).all()), s
        assert torch.equal(g, r), f"{s}: {float((g - r).abs().max()):.3e}"
        assert torch.equal(o, r), s


def test_registered_warp_form_matches_plain(card, registered):
    """A registered transition with a per-step stream and the table's radar
    under GH-16 (256 points) through ``engine="dd"``: one launch of the
    registered kernel's warp form, counted on it, equal to the plain version
    to the bit over 20 steps."""
    from ssmtoybox_torch.ops import vector_filter as vf
    dyn = _Driven(GaussRV(2, mean=[1.0, 0.0], cov=0.1 * np.eye(2), device=card),
                  GaussRV(2, cov=1e-3 * np.eye(2), device=card))
    alg = stt.GaussHermiteKalman(dyn, _radar(card, 2), deg=16)
    params = vf.prepare(dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_registered", vf._WARP)
    y = _zoo_records(card, dyn, alg.mod_obs, 1000)
    before = (vf.REGISTERED_LAUNCHES, vf.REGISTERED_WARP_LAUNCHES)
    res = alg.forward_pass_batch(y, engine="dd")
    assert (vf.REGISTERED_LAUNCHES - before[0], vf.REGISTERED_WARP_LAUNCHES - before[1]) == (1, 1)
    torch.cuda.synchronize()
    for f, r in zip(("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov"),
                    vf._vector_filter_plain(params, y)):
        g = getattr(res, f)
        g = g.permute(2, 1, 0) if g.ndim == 3 else g.permute(3, 1, 2, 0)
        assert bool(torch.isfinite(g).all()), f
        assert torch.equal(g, r), f"{f}: {float((g - r).abs().max()):.3e}"


# ---------------------------------------------------------------------------
# the slot design of the scalar kernel's general and registered forms
# (csrc/scalar_filter_slots.cuh): rules of up to 32 points on compile-time
# slots and lanes; above 32 points one thread a trajectory
# ---------------------------------------------------------------------------

#: the slot design's slot counts and the Gauss-Hermite degree that fills each
SLOT_COUNTS = [3, 5, 7, 8, 9, 12, 16]


def _slot_case(card, kinds, n, meas):
    """The UNGM transition with ``meas`` under GH-n (kind 0) or GPQ on GH-n
    points (kind 1) on each transform; at 16 slots GPQ takes 15 points (the
    phase 27 lane's rule, padded to 16 slots): on 16 Gauss-Hermite points
    the GP weights of ``KERN_PAR`` lose 10-99% of the runs, in the plain
    version too."""
    from ssmtoybox_torch.ssmod import Pendulum2DMeasurement, RangeMeasurement
    dyn = UNGMTransition(GaussRV(1, cov=5.0, device=card), GaussRV(1, cov=10.0, device=card))
    obs = {"range": lambda: RangeMeasurement(GaussRV(1, cov=0.03, device=card), dim_state=1),
           "sine": lambda: Pendulum2DMeasurement(GaussRV(1, cov=0.1, device=card), dim_state=1),
           "ungm": lambda: UNGMMeasurement(GaussRV(1, cov=1.0, device=card), dim_state=1)}[meas]()

    def rule(kind):
        return (stt.GaussHermiteKalman(dyn, obs, deg=n) if kind == 0 else
                stt.GaussianProcessKalman(dyn, obs, KERN_PAR, KERN_PAR, points="gh",
                                          point_hyp={"degree": 15 if n == 16 else n}))
    return sf.prepare(dyn, obs, rule(kinds[0]).tf_dyn, rule(kinds[1]).tf_obs), dyn, obs


def _slot_streams_equal(card, params, dyn, obs, seed, counter="GENERAL_LAUNCHES", slot=1):
    """Launch ``params`` at B = 1, 7, 4,097 and 10,000 (40 steps): one launch
    each, counted on ``counter`` and ``slot`` times on ``SLOT_LAUNCHES``,
    all five streams equal to the plain version's to the bit, a NaN where it
    has one (GPQ on 16 Gauss-Hermite points with the sine measurement loses
    some runs, in the plain version too), at least 99% of the 10,000 runs
    finite."""
    gen = torch.Generator(device=card).manual_seed(seed)
    x = dyn.simulate_discrete(gen, steps=40, mc_sims=10_000)
    y_all = obs.simulate_measurements(gen, x)[0].contiguous()
    c = sf.step_consts(params, 40, card)
    want = sf._scalar_filter_plain(params, y_all, c)
    for batch in (1, 7, 4097, 10_000):
        before = (sf.LAUNCHES, getattr(sf, counter), sf.SLOT_LAUNCHES)
        got = sf.scalar_filter(params, y_all[:, :batch].contiguous(), c)
        assert (sf.LAUNCHES - before[0], getattr(sf, counter) - before[1],
                sf.SLOT_LAUNCHES - before[2]) == (1, 1, slot)
        torch.cuda.synchronize()
        for s, g, r in zip(STREAMS, got, want):
            r = r[:, :batch]
            assert torch.equal(g.isnan(), r.isnan()), (batch, s)
            assert torch.equal(g.nan_to_num(), r.nan_to_num()), (
                f"B={batch} {s}: {float((g - r).nan_to_num().abs().max()):.3e}")
            assert batch < 10_000 or float(torch.isfinite(g).all(0).double().mean()) >= 0.99, s


#: (kinds, slots, measurement): the UNGM measurement above 8 points only
#: (below it the shaped form takes it)
SLOT_CASES = [(kinds, n, meas) for kinds in [(0, 0), (0, 1), (1, 0), (1, 1)]
              for n in SLOT_COUNTS for meas in ("range", "sine", "ungm")
              if meas != "ungm" or n > 8]


@pytest.mark.parametrize("kinds,n,meas", SLOT_CASES)
def test_slot_design_matches_plain_at_every_instantiation(card, kinds, n, meas):
    """Every instantiation of the general form's slot design (both kinds of
    either rule x 3-16 slots) with the range, sine and UNGM measurements (the
    UNGM one above 8 points; below it the shaped form takes it): one launch
    of the slot design a batch, equal to the plain version to the bit at B =
    1, 7, 4,097 and 10,000."""
    params, dyn, obs = _slot_case(card, kinds, n, meas)
    assert sf.form_of(params) == "general"
    assert sf.geometry(params)[:2] == ("slots", n)
    _slot_streams_equal(card, params, dyn, obs, seed=n + 10 * kinds[0] + 20 * kinds[1])


#: GPQ kernel parameters of rules of 17-32 Gauss-Hermite points: a length-scale
#: of 1 keeps every run finite there (``chip_smoke.UNGM_GPQ_WIDE_PAR``)
KERN_PAR_WIDE = np.array([[1.0, 1.0]])
#: (kinds, Gauss-Hermite points, measurement) of the slot design above 16
#: slots: 17 points padded to 20 slots, 24 and 32
WIDE_SLOT_CASES = [(kinds, n, meas) for kinds in [(0, 0), (0, 1), (1, 0), (1, 1)]
                   for n in (17, 24, 32) for meas in ("range", "sine", "ungm")]


@pytest.mark.parametrize("kinds,n,meas", WIDE_SLOT_CASES)
def test_wide_slot_design_matches_plain_at_every_instantiation(card, kinds, n, meas):
    """Every instantiation of the general form's slot design above 16 slots
    (both kinds of either rule x 20, 24 and 32 slots, ``scalar_filter_slots_wide.cu``)
    with the range, sine and UNGM measurements, under GH-n and GPQ on GH-n
    points (``KERN_PAR_WIDE``): one launch of the slot design a batch,
    equal to the plain version to the bit at B = 1, 7, 4,097 and 10,000."""
    from ssmtoybox_torch.ssmod import Pendulum2DMeasurement, RangeMeasurement
    dyn = UNGMTransition(GaussRV(1, cov=5.0, device=card), GaussRV(1, cov=10.0, device=card))
    obs = {"range": lambda: RangeMeasurement(GaussRV(1, cov=0.03, device=card), dim_state=1),
           "sine": lambda: Pendulum2DMeasurement(GaussRV(1, cov=0.1, device=card), dim_state=1),
           "ungm": lambda: UNGMMeasurement(GaussRV(1, cov=1.0, device=card), dim_state=1)}[meas]()
    rules = [stt.GaussHermiteKalman(dyn, obs, deg=n) if kind == 0 else
             stt.GaussianProcessKalman(dyn, obs, KERN_PAR_WIDE, KERN_PAR_WIDE, points="gh",
                                       point_hyp={"degree": n}) for kind in kinds]
    params = sf.prepare(dyn, obs, rules[0].tf_dyn, rules[1].tf_obs)
    assert sf.form_of(params) == "general"
    assert sf.geometry(params)[:2] == ("slots", {17: 20}.get(n, n))
    _slot_streams_equal(card, params, dyn, obs, seed=n + 10 * kinds[0] + 20 * kinds[1])


def test_one_thread_form_takes_rules_above_16_points(card):
    """GH-33, above the slot design's 32 points, runs one thread a
    trajectory: one general launch, none of the slot design, equal to the
    plain version to the bit at B = 1, 7, 4,097 and 10,000."""
    params, dyn, obs = _slot_case(card, (0, 0), 33, "ungm")
    assert sf.geometry(params) == ("one-thread", 0, 1)
    _slot_streams_equal(card, params, dyn, obs, seed=17, slot=0)


@pytest.mark.parametrize("rule", ["UKF", "GH-9", "GPQ-GH15", "GH-17", "GPQ-GH32"])
def test_registered_slot_design_matches_plain(card, registered, rule):
    """A registered transition (``_Growth``, its cosine a per-step stream)
    with the UNGM measurement in the registered form's slot design, at 3, 9,
    16, 20 and 32 slots: one launch a batch, counted on the registered form
    and the slot design, equal to the plain version to the bit at B = 1, 7,
    4,097 and 10,000."""
    dyn = _Growth(GaussRV(1, cov=1.0, device=card), GaussRV(1, cov=1.0, device=card))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0, device=card), dim_state=1)
    alg = {"UKF": lambda: stt.UnscentedKalman(dyn, obs),
           "GH-9": lambda: stt.GaussHermiteKalman(dyn, obs, deg=9),
           "GPQ-GH15": lambda: stt.GaussianProcessKalman(dyn, obs, KERN_PAR, KERN_PAR,
                                                         points="gh",
                                                         point_hyp={"degree": 15}),
           "GH-17": lambda: stt.GaussHermiteKalman(dyn, obs, deg=17),
           "GPQ-GH32": lambda: stt.GaussianProcessKalman(dyn, obs, KERN_PAR_WIDE, KERN_PAR_WIDE,
                                                         points="gh",
                                                         point_hyp={"degree": 32})}[rule]()
    params = sf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    assert sf.form_of(params) == "registered" and sf.geometry(params)[0] == "slots"
    _slot_streams_equal(card, params, dyn, obs, seed=23, counter="REGISTERED_LAUNCHES")


def test_registered_one_thread_form_takes_rules_above_16_points(card, registered):
    """The registered transition (``_Growth``) with the UNGM measurement
    under GH-33 runs the registered form one thread a trajectory
    (``scalar_filter_registered_kernel``): one registered launch a batch,
    none of the slot design, equal to the plain version to the bit at B = 1,
    7, 4,097 and 10,000."""
    dyn = _Growth(GaussRV(1, cov=1.0, device=card), GaussRV(1, cov=1.0, device=card))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0, device=card), dim_state=1)
    alg = stt.GaussHermiteKalman(dyn, obs, deg=33)
    params = sf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    assert sf.form_of(params) == "registered"
    assert sf.geometry(params) == ("one-thread", 0, 1)
    _slot_streams_equal(card, params, dyn, obs, seed=29, counter="REGISTERED_LAUNCHES", slot=0)


# ---------------------------------------------------------------------------
# the shaped one-thread form of the general and registered kernels
# (csrc/vector_filter_general_shaped.cuh): up to 4 outputs, both rules at
# the UT or CKF count
# ---------------------------------------------------------------------------

def _shaped_streams_equal(card, vf, params, dyn, obs, counter, batch):
    """One wrapper launch on ``batch`` trajectories, counted on ``counter``
    (the kernel's) and on the kernel's shaped form; its streams equal to the
    plain version's to the bit over 20 steps, a second launch equal to the
    first."""
    shaped = f"{counter.removesuffix('_LAUNCHES')}_SHAPED_LAUNCHES"
    y = _zoo_records(card, dyn, obs, batch)
    before = (vf.LAUNCHES, getattr(vf, counter), getattr(vf, shaped))
    got = vf.vector_filter(params, y)
    assert (vf.LAUNCHES - before[0], getattr(vf, counter) - before[1],
            getattr(vf, shaped) - before[2]) == (1, 1, 1)
    again = vf.vector_filter(params, y)
    torch.cuda.synchronize()
    for s, g, r, g2 in zip(STREAMS, got, vf._vector_filter_plain(params, y), again):
        assert bool(torch.isfinite(g).all()), s
        assert torch.equal(g, r), f"{s}: {float((g - r).abs().max()):.3e}"
        assert torch.equal(g, g2), s


@pytest.mark.parametrize("batch", [1, 7, 4097, 10000])
@pytest.mark.parametrize("case", [("radar", "UKF"), ("radar", "CKF"), ("2 bearings", "CKF"),
                                  ("3 bearings", "CKF"), ("radar", "UKF/CKF"),
                                  ("3 bearings", "CKF/UKF")], ids=" ".join)
def test_shaped_general_form_matches_plain(card, case, batch):
    """CT with the radar or 2-3 bearings under the UKF, the CKF or the two
    mixed (the first on the dynamics): the general kernel's shaped one-thread
    form, one launch counted on it, equal to the plain version to the bit
    over 20 steps at B = 1, 7, 4,097 and 10,000."""
    from ssmtoybox_torch.ops import vector_filter as vf
    obs_name, rule = case
    dyn, obs = (_general_systems(card)["ct_radar"] if obs_name == "radar" else
                _ct_bearings(card, int(obs_name.split()[0])))
    rules = {"UKF": stt.UnscentedKalman(dyn, obs), "CKF": stt.CubatureKalman(dyn, obs)}
    a, _, b = rule.partition("/")
    params = vf.prepare(dyn, obs, rules[a].tf_dyn, rules[b or a].tf_obs)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_general", vf._SHAPED)
    _shaped_streams_equal(card, vf, params, dyn, obs, "GENERAL_LAUNCHES", batch)


@pytest.mark.parametrize("batch", [1, 7, 4097, 10000])
@pytest.mark.parametrize("rule", ["UKF", "CKF", "GPQ"])
def test_shaped_registered_form_matches_plain(card, registered, rule, batch):
    """A registered transition with a per-step stream and the table's radar
    under the UKF, the CKF and GPQ (BQ rules on both transforms): the
    registered kernel's shaped one-thread form, one launch counted on it,
    equal to the plain version to the bit over 20 steps at B = 1, 7, 4,097
    and 10,000."""
    from ssmtoybox_torch.ops import vector_filter as vf
    dyn = _Driven(GaussRV(2, mean=[1.0, 0.0], cov=0.1 * np.eye(2), device=card),
                  GaussRV(2, cov=1e-3 * np.eye(2), device=card))
    obs = _radar(card, 2)
    par = np.array([[1.0, 3.0, 3.0]])
    alg = {"UKF": lambda: stt.UnscentedKalman(dyn, obs),
           "CKF": lambda: stt.CubatureKalman(dyn, obs),
           "GPQ": lambda: stt.GaussianProcessKalman(dyn, obs, par, par)}[rule]()
    params = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_registered", vf._SHAPED)
    _shaped_streams_equal(card, vf, params, dyn, obs, "REGISTERED_LAUNCHES", batch)


# ---------------------------------------------------------------------------
# Gauss-Hermite rules below 243 points: the shaped forms' Gauss-Hermite
# counts (csrc/vector_filter_shaped.cuh, VFS_GH / VGS_GH), the slot kernel
# (csrc/vector_filter_slots.cuh, VSL_SHAPES), the registered shaped form at
# mixed counts
# ---------------------------------------------------------------------------

#: (system, Gauss-Hermite degree) -> the kernel ``kernel_of`` names: GH-3 on
#: the pendulum (9 points) and GH-2 on the falling body (8) the classical
#: shaped kernel, 16-81 points the slot kernel
GH_CASES = {("pendulum", 3): "vector_filter_shaped", ("falling_body", 2): "vector_filter_shaped",
            ("reentry", 2): "vector_filter_slots", ("ct_bearing", 2): "vector_filter_slots",
            ("cv", 2): "vector_filter_slots", ("cv", 3): "vector_filter_slots",
            ("falling_body", 3): "vector_filter_slots"}


@pytest.mark.parametrize("batch", [1, 7, 4097])
@pytest.mark.parametrize("case", list(GH_CASES), ids=lambda c: f"{c[0]}-GH{c[1]}")
def test_gauss_hermite_shapes_match_plain(card, monkeypatch, case, batch):
    """Each Gauss-Hermite shape that left the first version: one launch,
    counted on the kernel ``kernel_of`` names, equal to the plain version to
    the bit over 20 steps, all five streams, a second launch equal to the
    first (the slot kernel's lanes gather by shuffle, the last warp ragged);
    the first version by force equal too."""
    from ssmtoybox_torch.ops import vector_filter as vf
    system, deg = case
    dyn, obs = ({**_zoo_systems(card), **{k: v[:2] for k, v in _vector_systems(card).items()}}
                [system])
    alg = stt.GaussHermiteKalman(dyn, obs, deg=deg)
    params = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    kernel = GH_CASES[case]
    assert (vf.kernel_of(params), vf.lanes_of(params)) == (kernel, 0)
    counter = "SLOT_LAUNCHES" if kernel == "vector_filter_slots" else "SHAPED_LAUNCHES"
    y = _zoo_records(card, dyn, obs, batch)
    before = (vf.LAUNCHES, getattr(vf, counter))
    got = vf.vector_filter(params, y)
    assert (vf.LAUNCHES - before[0], getattr(vf, counter) - before[1]) == (1, 1)
    again = vf.vector_filter(params, y)
    monkeypatch.setattr(vf, "kernel_of", lambda p: "vector_filter")
    first = vf.vector_filter(params, y)
    torch.cuda.synchronize()
    for s, g, r, g2, f in zip(STREAMS, got, vf._vector_filter_plain(params, y), again, first):
        assert _same_bits(g, r), f"{s}: {float((g - r).nan_to_num().abs().max()):.3e}"
        assert _same_bits(g, g2) and _same_bits(f, r), s


@pytest.mark.parametrize("batch", [1, 7, 4097])
@pytest.mark.parametrize("system", ["pendulum_ungm", "registered GH-3", "registered UKF/CKF"])
def test_shaped_forms_take_gauss_hermite_and_mixed_counts(card, registered, system, batch):
    """The general kernel's shaped form under GH-3 on the pendulum with the
    UNGM measurement (9 points, ``VGS_GH``), the registered kernel's under
    GH-3 and under the UKF beside the CKF on the driven pendulum with the
    radar: one launch counted on the form, equal to the plain version to the
    bit over 20 steps at B = 1, 7 and 4,097."""
    from ssmtoybox_torch.ops import vector_filter as vf
    if system == "pendulum_ungm":
        dyn, obs = _general_systems(card)[system]
        alg = stt.GaussHermiteKalman(dyn, obs, deg=3)
        counter = "GENERAL_LAUNCHES"
    else:
        dyn = _Driven(GaussRV(2, mean=[1.0, 0.0], cov=0.1 * np.eye(2), device=card),
                      GaussRV(2, cov=1e-3 * np.eye(2), device=card))
        obs = _radar(card, 2)
        alg = (stt.GaussHermiteKalman(dyn, obs, deg=3) if system.endswith("GH-3") else
               stt.GaussianInference(dyn, obs, stt.UnscentedKalman(dyn, obs).tf_dyn,
                                     stt.CubatureKalman(dyn, obs).tf_obs))
        counter = "REGISTERED_LAUNCHES"
    params = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    assert vf.lanes_of(params) == vf._SHAPED
    _shaped_streams_equal(card, vf, params, dyn, obs, counter, batch)


# ---------------------------------------------------------------------------
# the slot form of the general and registered kernels
# (csrc/vector_filter_general_slots.cuh): the general pairs' Gauss-Hermite
# shapes of 16-81 points in the slot kernel (VSL_GENERAL), a registered
# configuration's in the registered kernel's slot form (VFR_SLOTS)
# ---------------------------------------------------------------------------

def _gh_slot_systems(card):
    """The general kernel's pairs of ``VGS_PAIRS``, by name: (dynamics,
    measurement)."""
    from ssmtoybox_torch import ssmod

    def rv(d, mean, cov):
        return GaussRV(d, mean=mean, cov=cov, device=card)

    sensors = np.array([[0.0, 0.0], [200.0, 0.0], [0.0, 200.0], [200.0, 200.0]])
    dt = 0.01
    dyns = {
        "pendulum": lambda: ssmod.Pendulum2DTransition(
            rv(2, [1.5, 0.0], 0.01 * np.eye(2)),
            rv(2, None, 0.1 * np.array([[dt ** 3 / 3, dt ** 2 / 2], [dt ** 2 / 2, dt]])), dt=dt),
        "falling_body": lambda: ssmod.ReentryVehicle1DTransition(
            rv(3, [90.0, 6.0, 1.5], 0.09 * np.eye(3)), rv(3, None, 1e-8 * np.eye(3)), dt=0.1),
        "cv": lambda: ssmod.ConstantVelocity(rv(4, [100.0, 10.0, 100.0, 5.0],
                                                np.diag([10.0, 1.0, 10.0, 1.0])),
                                             rv(2, None, np.diag([0.5, 0.5])), dt=0.5),
        "ct": lambda: ssmod.CoordinatedTurnTransition(
            rv(5, [100.0, 10.0, 100.0, 5.0, 0.06], np.diag([10.0, 1.0, 10.0, 1.0, 1e-3])),
            rv(5, None, np.diag([0.1, 0.1, 0.1, 0.1, 1e-5])), dt=0.1),
        "reentry": lambda: ssmod.ReentryVehicle2DTransition(
            rv(5, [6500.4, 349.14, -1.8093, -6.7967, 0.6932],
               np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0])),
            rv(3, None, np.diag([2.4064e-5, 2.4064e-5, 1e-6])), dt=0.05)}

    def obs(kind, D):
        pos = [0, 2] if D >= 4 else [0, 1]
        if kind == "radar":
            return ssmod.Radar2DMeasurement(rv(2, None, np.diag([1.0, 1e-4])), dim_state=D,
                                            state_index=pos, radar_loc=np.array([-5.0, -5.0]))
        if kind == "sine":
            return ssmod.Pendulum2DMeasurement(rv(1, None, 0.1 * np.eye(1)), dim_state=D)
        if kind == "range":
            return ssmod.RangeMeasurement(rv(1, None, 0.03 * np.eye(1)), dim_state=D)
        if kind == "ungm":
            return UNGMMeasurement(rv(1, None, np.eye(1)), dim_state=D, state_index=[0])
        S = int(kind[1:])
        return ssmod.BearingMeasurement(rv(S, None, 1e-3 * np.eye(S)), dim_state=D,
                                        state_index=pos,
                                        sensor_pos=sensors[:S] / 100.0 - 1.0 if D == 2 else
                                        sensors[:S])

    dims = {"pendulum": 2, "falling_body": 3, "cv": 4, "ct": 5, "reentry": 5}
    return lambda d, o: (dyns[d](), obs(o, dims[d]))


#: (dynamics, measurement, Gauss-Hermite degree): every instantiation of
#: ``VSL_GENERAL``
GH_SLOT_CASES = [("pendulum", "radar", 4), ("pendulum", "ungm", 4), ("pendulum", "b3", 4),
                 ("falling_body", "sine", 3), ("falling_body", "b4", 3),
                 ("falling_body", "sine", 4), ("falling_body", "b4", 4), ("cv", "b2", 2),
                 ("cv", "b3", 2), ("cv", "b2", 3), ("cv", "b3", 3), ("ct", "radar", 2),
                 ("ct", "b2", 2), ("ct", "b3", 2), ("reentry", "range", 2), ("reentry", "ungm", 2)]


@pytest.mark.parametrize("batch", [1, 7, 4097])
@pytest.mark.parametrize("case", GH_SLOT_CASES, ids=lambda c: f"{c[0]}-{c[1]}-GH{c[2]}")
def test_general_pairs_in_the_slot_kernel_match_plain(card, case, batch):
    """Each general pair's Gauss-Hermite shape of the slot kernel: one launch
    counted on the slot kernel, equal to the plain version to the bit over
    20 steps, all five streams (NaN where it has NaN), a second launch equal
    to the first (the lanes gather by shuffle, the last warp ragged); the
    general kernel's one-thread form by force equal too."""
    from ssmtoybox_torch.ops import vector_filter as vf
    dyn, obs = _gh_slot_systems(card)(*case[:2])
    alg = stt.GaussHermiteKalman(dyn, obs, deg=case[2])
    params = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_slots", 0)
    y = _zoo_records(card, dyn, obs, batch)
    before = (vf.LAUNCHES, vf.SLOT_LAUNCHES)
    got = vf.vector_filter(params, y)
    assert (vf.LAUNCHES - before[0], vf.SLOT_LAUNCHES - before[1]) == (1, 1)
    again = vf.vector_filter(params, y)
    B, _, T = y.shape
    out = vf._empty_streams(params.dim_state, T, B, card)
    c = vf._c_general(params, card)
    scratch = vf._scratch(params, B, card)
    assert vf.build().vfg_launch(c, y.data_ptr(), *y.stride(), B, T, card.index or 0,
                                 *(o.data_ptr() for o in out), scratch.data_ptr(), 0,
                                 torch.cuda.current_stream(card).cuda_stream) == 0
    torch.cuda.synchronize()
    for s, g, r, g2, f in zip(STREAMS, got, vf._vector_filter_plain(params, y), again, out):
        assert _same_bits(g, r), f"{s}: {float((g - r).nan_to_num().abs().max()):.3e}"
        assert _same_bits(g, g2) and _same_bits(f, r), s


@pytest.mark.parametrize("batch", [1, 7, 4097])
def test_registered_slot_form_matches_plain(card, registered, batch):
    """The driven pendulum (a registered transition with a per-step stream)
    with the table's radar under GH-4 (16 points): one launch counted on the
    registered kernel and its slot form, equal to the plain version to the
    bit over 20 steps, a second launch equal to the first."""
    from ssmtoybox_torch.ops import vector_filter as vf
    dyn = _Driven(GaussRV(2, mean=[1.0, 0.0], cov=0.1 * np.eye(2), device=card),
                  GaussRV(2, cov=1e-3 * np.eye(2), device=card))
    obs = _radar(card, 2)
    alg = stt.GaussHermiteKalman(dyn, obs, deg=4)
    params = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    assert vf.lanes_of(params) == vf._SLOTS
    y = _zoo_records(card, dyn, obs, batch)
    before = (vf.LAUNCHES, vf.REGISTERED_LAUNCHES, vf.REGISTERED_SLOT_LAUNCHES)
    got = vf.vector_filter(params, y)
    assert (vf.LAUNCHES - before[0], vf.REGISTERED_LAUNCHES - before[1],
            vf.REGISTERED_SLOT_LAUNCHES - before[2]) == (1, 1, 1)
    again = vf.vector_filter(params, y)
    torch.cuda.synchronize()
    for s, g, r, g2 in zip(STREAMS, got, vf._vector_filter_plain(params, y), again):
        assert bool(torch.isfinite(g).all()), s
        assert torch.equal(g, r), f"{s}: {float((g - r).abs().max()):.3e}"
        assert torch.equal(g, g2), s
