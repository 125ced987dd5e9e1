"""The fused scalar filter (``ssmtoybox_torch/ops/scalar_filter.py``).

On the CPU its wrapper runs the plain PyTorch twin, which is held against:

- the JAX package's Pallas kernel ``ops/ddscan_pallas.py::pallas_scalar_filter``
  in interpret mode (``scalar_filter_batch(engine="pallas")``, as
  ``test_ddfilter.py`` runs it) on the records of ``test_ddfilter.py``, at
  1e-8: the double-double kernel's contract on these records;
- the JAX float64 ``gaussian_filter_batch``, every moment stream, at 1e-10
  over the first 20 steps and 1e-8 over all 100 (both float64, different
  summation order, which the UNGM map amplifies).

The CUDA step header, compiled for the host with g++, equals the twin to the
bit (same operations in the same order) at every instantiation the launcher
can pick: both kinds at 3, 5 and 7 points, mixed kinds, and shapes that run
padded (4 and 8 points, 5 with 3).  The lanes of the kernel itself run only on
the card: ``tests/test_torch_cuda.py``.  The wrapper's caches (a transform's
rule, the parameter struct, the UNGM constants) are held to serve every
object its own result.
"""
import ast
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu.ops.ddfilter import scalar_filter_batch as jax_scalar_filter_batch
from ssmtoybox_tpu.ssmod import UNGMMeasurement as JUNGMMeasurement
from ssmtoybox_tpu.ssmod import UNGMTransition as JUNGMTransition
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
import ssmtoybox_torch as stt
from ssmtoybox_torch.mtran import GaussHermiteTransform, SigmaPointTransform
from ssmtoybox_torch.ops import scalar_filter as sf
from ssmtoybox_torch.ssmod import (Radar2DMeasurement, ReentryVehicle2DTransition,
                                   UNGMMeasurement, UNGMTransition)
from ssmtoybox_torch.utils import GaussRV
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


KERN_PAR = np.array([[1.0, 3.0]])
STREAMS = ("m_fi", "P_fi", "m_pr", "P_pr", "xx")
FIELDS = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")


def _models():
    return (UNGMTransition(GaussRV(1, cov=5.0), GaussRV(1, cov=10.0)),
            UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1))


ALGS = {
    "ukf": (lambda d, o: stt.UnscentedKalman(d, o), lambda d, o: st.UnscentedKalman(d, o)),
    "gpqkf": (lambda d, o: stt.GaussianProcessKalman(d, o, KERN_PAR, KERN_PAR),
              lambda d, o: st.GaussianProcessKalman(d, o, KERN_PAR, KERN_PAR, points="ut")),
}


@pytest.fixture(scope="module")
def records():
    """The records of ``test_ddfilter.py::_ungm(steps=100, mc=8)`` with the
    JAX Pallas kernel's (interpret mode) and the JAX f64 filter's results."""
    jd = JUNGMTransition.create(JGaussRV.create(1, cov=5.0), JGaussRV.create(1, cov=10.0))
    jo = JUNGMMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1)
    x = jd.simulate_discrete(jax.random.PRNGKey(2), steps=100, mc_sims=8)
    ys = jnp.moveaxis(jo.simulate_measurements(jax.random.PRNGKey(3), x), -1, 0)
    out = {"ys": np.array(ys)}
    for name, (_, make_j) in ALGS.items():
        alg = make_j(jd, jo)
        out[name, "pallas"] = np.asarray(jax_scalar_filter_batch(
            jd, jo, alg.tf_dyn, alg.tf_obs, ys, engine="pallas", block_b=128))
        out[name, "f64"] = jax.jit(lambda b: st.gaussian_filter_batch(
            jd, jo, alg.tf_dyn, alg.tf_obs, b))(ys)
    return out


@pytest.mark.parametrize("name", sorted(ALGS))
def test_twin_matches_jax_pallas_kernel(records, name):
    alg = ALGS[name][0](*_models())
    got = sf.scalar_filter_batch(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs,
                                 torch.as_tensor(records["ys"]))
    assert tuple(got.shape) == records[name, "pallas"].shape
    np.testing.assert_allclose(got.numpy(), records[name, "pallas"], atol=1e-8, rtol=1e-8)


@pytest.mark.parametrize("name", sorted(ALGS))
def test_twin_matches_jax_f64_filter(records, name):
    """All five streams at 1e-10 over the first 20 steps, and at the 1e-8
    parity tolerance over all 100.  Past step 20 the UNGM map grows the
    summation-order differences between any two float64 implementations on
    some records: the port's own eager f64 path differs from the JAX package
    by up to 1.2e-9 relative on record 3 of these (GPQ, near step 26)."""
    alg = ALGS[name][0](*_models())
    res = alg.forward_pass_batch(records["ys"], engine="dd")
    ref = records[name, "f64"]
    for f in FIELDS:
        got, want = getattr(res, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_allclose(got[..., :20], want[..., :20], atol=1e-10, rtol=1e-10,
                                   err_msg=f)
        np.testing.assert_allclose(got, want, atol=1e-8, rtol=1e-8, err_msg=f)


def _streams(seed, n_steps, batch):
    rng = np.random.default_rng(seed)
    y = torch.as_tensor(rng.normal(2.0, 4.0, size=(n_steps, batch)))
    return y, torch.as_tensor(sf.ungm_consts(n_steps))


def _twin_ieee(params, y, c):
    """The twin with a correctly rounded square root (numpy's), as the card
    and g++ take it: PyTorch's vectorised CPU ``sqrt`` is an ulp off on some
    inputs, which the UNGM map grows to ~1e-11 within 30 steps."""
    return sf._scalar_filter_plain(params, y, c,
                                   sqrt=lambda t: torch.from_numpy(np.sqrt(t.numpy())))


def _shape_cases():
    """Every instantiation of the step (kinds of the dynamics and the
    measurement rule, slots): ``name -> (dyn rule from, obs rule from, kinds,
    slots)``, the rules taken from the filters of ``ALGS``, ``WIDE`` and
    ``PADDED`` below."""
    same = {"ukf": (0, 3), "gpqkf": (1, 3), "gh5": (0, 5), "bsq_gh5": (1, 5), "gh7": (0, 7),
            "bsq_gh7": (1, 7), "gpq_gh7": (1, 7), "gh4": (0, 5), "gh8": (0, 8),
            "gpq_gh8": (1, 8), "gh2": (0, 3)}
    cases = {name: (name, name, (kind, kind), n) for name, (kind, n) in same.items()}
    cases["bsq_gh5_then_ukf"] = ("bsq_gh5", "ukf", (1, 0), 5)        # mixed kinds and points
    cases["gh7_then_gpqkf"] = ("gh7", "gpqkf", (0, 1), 7)
    cases["gh5_then_gh8"] = ("gh5", "gh8", (0, 0), 8)
    return cases


def _shape_params(case):
    from_dyn, from_obs, kinds, n_slots = _shape_cases()[case]
    makers = {**{k: v[0] for k, v in ALGS.items()}, **WIDE, **PADDED}
    dyn, obs = _models()
    params = sf.prepare(dyn, obs, makers[from_dyn](dyn, obs).tf_dyn,
                        makers[from_obs](dyn, obs).tf_obs)
    assert (params.dyn.kind, params.obs.kind) == kinds and sf.slots(params) == n_slots
    return params


@pytest.mark.parametrize("name", sorted(_shape_cases()))
def test_step_header_on_host_matches_twin(name):
    """``csrc/scalar_filter_step.cuh`` built with g++ == the twin, to the bit,
    at the instantiation the launcher picks for the shape; time-major and
    trajectory-major measurements alike."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the step header cannot be built for the host")
    params = _shape_params(name)
    y, c = _streams(0, 30, 64)
    want = _twin_ieee(params, y, c)
    by_traj = y.T.contiguous().T                      # the same values, strides (1, N)
    assert not by_traj.is_contiguous()
    for got in (sf._host_shim_run(params, y, c), sf._host_shim_run(params, by_traj, c)):
        for s, a, b in zip(STREAMS, got, want):
            assert bool(torch.isfinite(b).all()), s
            assert torch.equal(a, b), f"{s}: {float((a - b).abs().max()):.3e}"


@pytest.mark.parametrize("batch", [1, 7])
def test_step_header_on_host_takes_any_batch(batch):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the step header cannot be built for the host")
    params = _shape_params("bsq_gh5_then_ukf")
    y, c = _streams(batch, 12, batch)
    for a, b in zip(sf._host_shim_run(params, y, c), _twin_ieee(params, y, c)):
        assert torch.equal(a, b)


def test_wrapper_on_cpu_runs_the_twin_and_counts_no_launch():
    alg = ALGS["ukf"][0](*_models())
    params = sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    y, c = _streams(1, 5, 7)
    before = sf.LAUNCHES
    for a, b in zip(sf.scalar_filter(params, y, c), sf._scalar_filter_plain(params, y, c)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert sf.LAUNCHES == before


def test_wrapper_checks_its_inputs():
    alg = ALGS["ukf"][0](*_models())
    params = sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    y, c = _streams(2, 4, 3)
    with pytest.raises(TypeError, match="float64"):
        sf.scalar_filter(params, y.float(), c)
    with pytest.raises(ValueError, match="contiguous"):
        sf.scalar_filter(params, torch.as_tensor(np.zeros((4, 6)))[:, ::2], c)
    with pytest.raises(ValueError, match=r"\(N, B\)"):
        sf.scalar_filter(params, y, c[:2])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sf.scalar_filter(params, y.to("meta"), c.to("meta"))


def test_batch_entry_point_takes_both_layouts():
    alg = ALGS["gpqkf"][0](*_models())
    y = torch.as_tensor(np.random.default_rng(3).normal(size=(5, 9)))
    a = sf.scalar_filter_batch(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs, y)
    b = sf.scalar_filter_batch(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs, y[:, None])
    assert tuple(a.shape) == (5, 1, 9)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_wrapper_takes_trajectory_major_measurements():
    """The transpose of a contiguous (B, N) batch goes in as it is and gives
    the bits of its time-major copy."""
    alg = ALGS["gpqkf"][0](*_models())
    params = sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    y, c = _streams(4, 9, 5)
    view = y.T.contiguous().T
    for a, b in zip(sf.scalar_filter(params, view, c), sf.scalar_filter(params, y, c)):
        assert torch.equal(a, b) and a.is_contiguous()


def test_a_replaced_transform_gets_its_own_rule():
    """A transform's lowered rule is kept on it; ``replace()`` copies the
    object, and the copy must be lowered from its own weights."""
    alg = WIDE["bsq_gh5"](*_models())
    tf = alg.tf_dyn
    rule = sf.lower_transform(tf)
    assert sf.lower_transform(tf) is rule                              # kept
    tf2 = tf.replace(model_var=float(tf.model_var) + 0.5)
    rule2 = sf.lower_transform(tf2)
    assert rule2.emv == pytest.approx(rule.emv + 0.5) and rule2.Wc == rule.Wc
    tf3 = tf.replace(wm=torch.flip(tf.wm, (0,)))
    assert sf.lower_transform(tf3).wm == rule.wm[::-1]
    assert sf.lower_transform(tf) is rule and sf.lower_transform(tf2) is rule2
    # and a filter built on the copy filters with the copy's variance
    ys = np.random.default_rng(8).normal(size=(3, 1, 6))
    a = stt.gaussian_filter_batch(alg.mod_dyn, alg.mod_obs, tf, alg.tf_obs, ys, engine="dd")
    b = stt.gaussian_filter_batch(alg.mod_dyn, alg.mod_obs, tf2, alg.tf_obs, ys, engine="dd")
    torch.testing.assert_close(b.pr_cov[..., 0] - a.pr_cov[..., 0],
                               torch.full((3, 1, 1), 0.5, dtype=torch.float64))


def test_the_fused_engine_lowers_a_configuration_once(monkeypatch):
    """``engine="dd"`` lowers each transform on the first call only, and once
    a call reads the models' constants from where the first call left them."""
    alg = WIDE["gh7"](*_models())
    calls = []
    lower = sf._lower
    monkeypatch.setattr(sf, "_lower", lambda tf: calls.append(tf) or lower(tf))
    ys = np.random.default_rng(9).normal(size=(2, 1, 5))
    first = alg.forward_pass_batch(ys, engine="dd")
    assert len(calls) == 2                                             # dyn and obs
    scalars = []
    monkeypatch.setattr(sf, "_scalar", lambda t: scalars.append(t) or 0.0)
    second = alg.forward_pass_batch(ys, engine="dd")
    assert len(calls) == 2 and not scalars
    assert torch.equal(first.fi_mean, second.fi_mean)
    # a new initial state is read, and is not served the models' own
    third = alg.forward_pass_batch(ys, engine="auto")
    assert torch.equal(first.fi_cov, third.fi_cov)
    monkeypatch.undo()
    moved = stt.gaussian_filter_batch(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs, ys,
                                      init_mean=torch.tensor([3.0]), engine="dd")
    assert float((moved.pr_mean[..., 0] - first.pr_mean[..., 0]).abs().min()) > 0.1
    again = alg.forward_pass_batch(ys, engine="dd")
    assert torch.equal(first.fi_mean, again.fi_mean)


@pytest.mark.parametrize("inference", [False, True])
@pytest.mark.parametrize("name", ["ukf", "bsq_gh5"])
def test_an_edited_transform_is_lowered_anew(monkeypatch, name, inference):
    """A transform's rule is kept for as long as its weights are not edited
    in place: after ``tf.wm.mul_(...)`` (classical) or ``tf.Wc[...] = ...``
    (BQ) the fused engine lowers it again and agrees with the eager float64
    path, within ``test_wide_rules_fused_match_eager_f64``'s 1e-9 over 20
    steps; without an edit the rule is not lowered again.  A transform built
    under ``torch.inference_mode`` has weights that count no edits, and its
    rule is lowered at every call."""
    with torch.inference_mode(inference):
        alg = {**{k: v[0] for k, v in ALGS.items()}, **WIDE}[name](*_models())
        calls = []
        lower = sf._lower
        monkeypatch.setattr(sf, "_lower", lambda tf: calls.append(tf) or lower(tf))
        ys = np.random.default_rng(10).normal(0.0, 3.0, size=(4, 1, 20))
        before = alg.forward_pass_batch(ys, engine="dd")
        alg.forward_pass_batch(ys, engine="dd")
        assert len(calls) == (4 if inference else 2)                   # kept: dyn and obs
        if name == "ukf":
            alg.tf_dyn.wm.mul_(1.01)
        else:
            alg.tf_dyn.Wc[0, 0] = alg.tf_dyn.Wc[0, 0] * 1.01
        fused, eager = alg.forward_pass_batch(ys, engine="dd"), alg.forward_pass_batch(ys)
        if not inference:
            assert len(calls) == 3 and calls[-1] is alg.tf_dyn         # the edited one only
        assert float((fused.fi_mean - before.fi_mean).abs().max()) > 1e-6
        for f in FIELDS:
            np.testing.assert_allclose(getattr(fused, f).numpy(), getattr(eager, f).numpy(),
                                       atol=1e-9, rtol=1e-9, err_msg=f)


def test_every_parameter_set_gets_its_own_struct():
    p1, p2 = _shape_params("ukf"), _shape_params("gh5")
    c1, c2 = sf._c_params(p1), sf._c_params(p2)
    assert sf._c_params(p1) is c1 and c2 is not c1
    assert (c1.dyn.n, c2.dyn.n) == (3, 5) and list(c2.dyn.xi[:5]) == list(p2.dyn.xi)
    assert list(c1.dyn.xi[3:]) == [0.0] * 5 and list(c1.obs.Wc) == [0.0] * 64   # zero padding
    other = sf.ScalarFilterParams(p1.dyn, p1.obs, p1.m0 + 1.0, p1.P0, p1.gqg, p1.r)
    assert sf._c_params(other).m0 == p1.m0 + 1.0 and sf._c_params(p1).m0 == p1.m0
    a, b = sf._ungm_consts_on(4, torch.device("cpu")), sf._ungm_consts_on(5, torch.device("cpu"))
    assert a.shape == (4,) and b.shape == (5,) and sf._ungm_consts_on(4, a.device) is a


def test_supports():
    dyn, obs = _models()
    for name in ALGS:
        alg = ALGS[name][0](dyn, obs)
        assert sf.supports(dyn, obs, alg.tf_dyn, alg.tf_obs)
    ukf = stt.UnscentedKalman(dyn, obs)
    gh7 = GaussHermiteTransform(1, degree=7)
    assert sf.supports(dyn, obs, gh7, gh7)                            # 7 points <= 8
    gh9 = GaussHermiteTransform(1, degree=9)
    assert sf.supports(dyn, obs, gh9, ukf.tf_obs)                     # 9 points: the general form
    tpq = stt.StudentProcessKalman(dyn, obs, KERN_PAR, KERN_PAR)
    assert not sf.supports(dyn, obs, tpq.tf_dyn, ukf.tf_obs)          # TPQ
    dense = SigmaPointTransform(ukf.tf_dyn.unit_sp, ukf.tf_dyn.wm, Wc_dense=ukf.tf_dyn.Wc)
    assert not sf.supports(dyn, obs, dense, ukf.tf_obs)               # dense classical
    re = ReentryVehicle2DTransition(GaussRV(5), GaussRV(3))
    radar = Radar2DMeasurement(GaussRV(2), dim_state=5, state_index=[0, 1])
    ukf_re = stt.UnscentedKalman(re, radar)
    assert not sf.supports(re, radar, ukf_re.tf_dyn, ukf_re.tf_obs)   # not scalar


def test_ungm_time_index():
    """Measurement k (1-based) uses the dynamics at time k - 1."""
    np.testing.assert_allclose(sf.ungm_consts(3), 8.0 * np.cos(1.2 * np.arange(3)), atol=0)
    assert sf.ungm_consts(1)[0] == 8.0


def test_parameter_struct_matches_the_header():
    """The ctypes mirror of ``SfRule``/``SfParams`` has the header's fields."""
    src = open(sf._build.CSRC + "/scalar_filter_step.cuh").read()
    for field, _ in sf._CRule._fields_:
        assert f" {field}" in src.split("struct SfRule")[1].split("};")[0], field
    for field, _ in sf._CParams._fields_:
        assert f" {field}" in src.split("struct SfParams")[1].split("};")[0], field
    assert f"#define SF_MAX_PTS {sf.MAX_PTS}" in src


def test_no_module_of_the_port_imports_jax():
    """Parse every file of the port (and chip_smoke.py); no import may name
    jax, flax or ssmtoybox_tpu.  Static, so no interpreter start-up hook that
    imports jax can hide an import."""
    import pathlib
    root = pathlib.Path(stt.__file__).parent
    files = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    banned = ("jax", "flax", "ssmtoybox_tpu")
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{path}: {n}" for n in names if n.split(".")[0] in banned]
    assert len(files) > 10
    assert not offenders, offenders


# ---------------------------------------------------------------------------
# rules of up to 8 points: Gauss-Hermite and the BSQ and GPQ rules on GH points
# ---------------------------------------------------------------------------

GH5_PAR, GH7_PAR = np.array([[5.0, 0.6]]), np.array([[3.0, 0.4]])
WIDE = {
    "gh7": lambda d, o: stt.GaussHermiteKalman(d, o, deg=7),
    "gpq_gh7": lambda d, o: stt.GaussianProcessKalman(d, o, GH7_PAR, GH7_PAR, points="gh",
                                                      point_hyp={"degree": 7}),
    "bsq_gh5": lambda d, o: stt.BayesSardKalman(d, o, GH5_PAR, GH5_PAR,
                                                mulind_dyn=np.atleast_2d(np.arange(5)),
                                                mulind_obs=np.atleast_2d(np.arange(5)),
                                                points="gh", point_hyp={"degree": 5}),
    "bsq_gh7": lambda d, o: stt.BayesSardKalman(d, o, GH7_PAR, GH7_PAR,
                                                mulind_dyn=np.atleast_2d(np.arange(7)),
                                                mulind_obs=np.atleast_2d(np.arange(7)),
                                                points="gh", point_hyp={"degree": 7}),
}


#: rules that run padded: 4 points at 5 slots, 2 at 3, 8 at 8
PADDED = {
    "gh2": lambda d, o: stt.GaussHermiteKalman(d, o, deg=2),
    "gh4": lambda d, o: stt.GaussHermiteKalman(d, o, deg=4),
    "gh5": lambda d, o: stt.GaussHermiteKalman(d, o, deg=5),
    "gh8": lambda d, o: stt.GaussHermiteKalman(d, o, deg=8),
    "gpq_gh8": lambda d, o: stt.GaussianProcessKalman(d, o, GH7_PAR, GH7_PAR, points="gh",
                                                      point_hyp={"degree": 8}),
}


def _golden_models():
    """The UNGM system of ``tests/goldens/ungm.npz`` (initial variance 1)."""
    return (UNGMTransition(GaussRV(1, cov=1.0), GaussRV(1, cov=10.0)),
            UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1))


def test_gh5_through_the_fused_engine_matches_golden(goldens):
    """Gauss-Hermite, 5 points, through ``engine="dd"`` (the kernel's twin
    on the CPU) on ``ungm.npz``'s ``ghkf5``, 1e-8.  Refused for its 5 points
    while the kernel took at most 3."""
    g = goldens["ungm"]
    dyn, obs = _golden_models()
    gh5 = GaussHermiteTransform(1, degree=5)
    res = stt.gaussian_filter_batch(dyn, obs, gh5, gh5, np.moveaxis(g["y"], -1, 0), engine="dd")
    np.testing.assert_allclose(res.fi_mean[0].numpy(), g["ghkf5_fm"], atol=1e-8, rtol=1e-8)
    np.testing.assert_allclose(res.fi_cov[0].numpy(), g["ghkf5_fP"], atol=1e-8, rtol=1e-8)


def test_bsqkf_through_the_fused_engine_matches_golden(goldens):
    """The BSQ UT filter and its smoother through ``engine="dd"`` on
    ``ungm.npz``'s ``bsqkf``, 1e-8."""
    g = goldens["ungm"]
    par, mi = np.array([[3.0, 0.3]]), np.array([[0, 1, 2]])
    alg = stt.BayesSardKalman(*_golden_models(), par, par, mulind_dyn=mi, mulind_obs=mi)
    res = alg.forward_pass_batch(np.moveaxis(g["y"], -1, 0), engine="dd")
    sm, sP = stt.gaussian_smoother(res)
    for got, key in ((res.fi_mean[0], "fm"), (res.fi_cov[0], "fP"), (sm[0], "sm"),
                     (sP[0], "sP")):
        np.testing.assert_allclose(got.numpy(), g[f"bsqkf_{key}"], atol=1e-8, rtol=1e-8,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(WIDE))
def test_wide_rules_fused_match_eager_f64(records, name):
    """7- and 5-point rules through ``engine="dd"`` against the port's eager
    float64 path, every moment stream over the first 20 steps, 1e-9."""
    alg = WIDE[name](*_models())
    assert sf.supports(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    ys = records["ys"][..., :20]
    fused, eager = alg.forward_pass_batch(ys, engine="dd"), alg.forward_pass_batch(ys)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(fused, f).numpy(), getattr(eager, f).numpy(),
                                   atol=1e-9, rtol=1e-9, err_msg=f)


@pytest.mark.parametrize("name", ["gh7", "bsq_gh7"])
def test_step_header_on_host_matches_twin_at_7_points(name):
    """The step header built with g++ == the twin for 7-point rules, to the bit."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the step header cannot be built for the host")
    alg = WIDE[name](*_models())
    params = sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    assert params.dyn.n == params.obs.n == 7
    y, c = _streams(5, 30, 64)
    for s, a, b in zip(STREAMS, sf._host_shim_run(params, y, c), _twin_ieee(params, y, c)):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=s)
