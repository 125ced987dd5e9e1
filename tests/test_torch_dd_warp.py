"""The warp form of the general and registered vector filter kernels
(``vfl_step`` on G = 32 lanes in ``csrc/vector_filter_lanes.cuh``): a
trajectory on a whole warp for rules of many points, its offsets recomputed
a tile of 32 points at a time, each entry of a sum on one lane, so that it
gives the one-thread step's bits.  ``ops.vector_filter.lanes_of`` sends it
the shapes whose rules have at least ``_WARP_MIN_POINTS`` points, and
``kernel_of`` the Gauss-Hermite rules of the five pairs that the first
version instantiates.

- Host build: the warp form compiled with g++ (``vector_filter_host.cpp``,
  its 32 lanes run one after another in each phase) equals the plain
  version with the C library's transcendentals, to the bit: reentry + radar,
  CT with 8 and 9 bearings under GH-3, a registered pendulum with the radar
  under GH-16, the reentry transition of the table with a registered copy
  of the radar under GH-3 (equal to the table's radar too), and GPQ on GH-3
  points with CT and the radar; on 4 trajectories and on a ragged 5,
  measurements read through their strides.
- Against the JAX package's float64 filter: a record of reentry + radar
  under GH-3, all five streams at 1e-10.
- Routing: ``kernel_of`` and ``lanes_of`` on the shapes that move to the
  warp form and on those that keep their route (mixed counts, few points, a
  state whose values do not fit in a block's shared memory), and the
  header's reckoning of the form (``vfl_fit_on``) against the rule it
  states.

Measurements come from a numpy seed, simulated through the port's model
functions with numpy noise, 20 steps.
"""
import math
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu import ssmod as jssmod
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import set_device, ssmod
from ssmtoybox_torch.ops import KernelForm, forms, register_dyn_dd_vec, register_obs_dd_vec
from ssmtoybox_torch.ops import vector_filter as vf
from ssmtoybox_torch.utils import GaussRV
from test_torch_dd_lanes import LIBM_FNS, SENSORS


class PendCopy(ssmod.Pendulum2DTransition):
    """The table's pendulum registered with its form's statements."""


def _pend_lower(model, n_steps):
    def plain(x, c, s, fns):
        x0, x1 = x.unbind(-1)
        return torch.stack([x0 + x1 * c[0], x1 - c[1] * fns.sin(x0)], -1)
    return [], KernelForm("f[0] = x[0] + x[1] * c[0];\nf[1] = x[1] - c[1] * sin(x[0]);",
                          (model.dt, model.g * model.dt), plain)


class RadarCopy(ssmod.Radar2DMeasurement):
    """The table's radar registered with the statements of its form."""


def _radar_lower(model):
    i, j = model.state_index

    def plain(x, c, fns):
        dx, dy = x[..., i] - c[0], x[..., j] - c[1]
        return torch.stack([fns.sqrt(dx * dx + dy * dy), fns.atan2(dy, dx)], -1)
    return KernelForm(f"const double dx = x[{i}] - c[0];\nconst double dy = x[{j}] - c[1];\n"
                      "h[0] = sqrt(dx * dx + dy * dy);\nh[1] = atan2(dy, dx);",
                      tuple(model.radar_loc.tolist()), plain)


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port runs on the card unless told otherwise; these tests run it
    on the CPU, on one intra-op thread (the suite runs several workers at
    once), with the pendulum and radar copies registered (unregistered when
    the module ends: the registries are module globals)."""
    set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    register_dyn_dd_vec(PendCopy, _pend_lower)
    register_obs_dd_vec(RadarCopy, _radar_lower)
    yield
    forms.DYN_DD_VEC.pop(PendCopy, None)
    forms.OBS_DD_VEC.pop(RadarCopy, None)
    torch.set_num_threads(threads)
    set_device(None)


FIELDS = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")
T = 20
CT_M0, CT_P0 = np.array([100.0, 10.0, 100.0, 5.0, 0.06]), np.diag([10.0, 1.0, 10.0, 1.0, 1e-3])
RE_M0 = np.array([6500.4, 349.14, -1.8093, -6.7967, 0.6932])


def _system(name, jax_side=False):
    """(transition, measurement) in the port or the JAX package: ``reentry``,
    the bench lane's reentry with the radar; ``ct-radar``, the coordinated
    turn with the radar; ``ct-b<S>``, with S bearings; ``falling``, the
    falling body with its range; ``cv``, constant velocity with the radar;
    ``pend-copy``, the registered pendulum with the radar, ``reentry-copy``,
    the reentry transition with the registered radar copy (the port only)."""
    if jax_side:
        new, rv = (lambda cls: getattr(jssmod, cls).create), (
            lambda d, m, c: JGaussRV.create(d, mean=m, cov=c))
    else:
        new, rv = (lambda cls: getattr(ssmod, cls)), (lambda d, m, c: GaussRV(d, mean=m, cov=c))
    radar = RadarCopy if name == "reentry-copy" else new("Radar2DMeasurement")
    if name.startswith("reentry"):
        d = new("ReentryVehicle2DTransition")(
            rv(5, RE_M0, np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0])),
            rv(3, None, np.diag([2.4064e-5, 2.4064e-5, 1e-6])), dt=0.05)
        return d, radar(rv(2, None, np.diag([1e-3, 1e-5])), dim_state=5, state_index=[0, 1],
                        radar_loc=np.array([6374.0, 0.0]))
    if name == "falling":
        d = new("ReentryVehicle1DTransition")(rv(3, np.array([90.0, 6.0, 1.5]), 0.09 * np.eye(3)),
                                              rv(3, None, 1e-8 * np.eye(3)), dt=0.1)
        return d, new("RangeMeasurement")(rv(1, None, 0.03 * np.eye(1)), dim_state=3)
    if name == "cv":
        d = new("ConstantVelocity")(rv(4, np.array([10000.0, 300.0, 1000.0, -40.0]),
                                       np.diag([1e4, 1e2, 1e4, 1e2])),
                                    rv(2, None, np.diag([50.0, 5.0])), dt=0.5)
        return d, radar(rv(2, None, np.diag([50.0, 0.4e-6])), dim_state=4,
                        state_index=[0, 2, 1, 3])
    if name == "pend-copy":
        d = PendCopy(rv(2, np.array([1.5, 0.0]), 0.01 * np.eye(2)),
                     rv(2, None, 1e-4 * np.eye(2)), dt=0.01)
        return d, radar(rv(2, None, np.diag([0.01, 1e-3])), dim_state=2, state_index=[0, 1],
                        radar_loc=np.array([-2.0, -2.0]))
    d = new("CoordinatedTurnTransition")(rv(5, CT_M0, CT_P0),
                                         rv(5, None, np.diag([0.1, 0.1, 0.1, 0.1, 1e-5])),
                                         dt=0.1)
    if name == "ct-radar":
        return d, radar(rv(2, None, np.diag([1.0, 1e-4])), dim_state=5, state_index=[0, 2],
                        radar_loc=np.array([-5.0, -5.0]))
    S = int(name[4:])
    return d, new("BearingMeasurement")(rv(S, None, 1e-3 * np.eye(S)), dim_state=5,
                                        state_index=[0, 2], sensor_pos=SENSORS[:S])


def _kpar(D):
    return np.array([[1.0] + [3.0] * D])


#: rule -> (maker in the port, maker in the JAX package)
RULES = {
    "ukf": (lambda d, o: stt.UnscentedKalman(d, o), lambda d, o: st.UnscentedKalman(d, o)),
    "gh3": (lambda d, o: stt.GaussHermiteKalman(d, o, deg=3),
            lambda d, o: st.GaussHermiteKalman(d, o, deg=3)),
    "gh16": (lambda d, o: stt.GaussHermiteKalman(d, o, deg=16), None),
    "gpq-gh3": (lambda d, o: stt.GaussianProcessKalman(d, o, _kpar(d.dim_state),
                                                       _kpar(d.dim_state), points="gh",
                                                       point_hyp={"degree": 3}), None),
}


def _params(name, rule):
    if "/" in rule:                     # mixed: the first rule's dynamics, the second's measurement
        first, second = (RULES[r][0](*_system(name)) for r in rule.split("/"))
        first.tf_obs = second.tf_obs
        alg = first
    else:
        alg = RULES[rule][0](*_system(name))
    return vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)


def _simulate(name, B, seed=0):
    """(B, E, T) measurements simulated with numpy noise through the port's
    model functions (truth from step 0, measurement k of the state at step
    k)."""
    d, o = _system(name)
    rng = np.random.default_rng(seed)
    m0, P0 = (t.numpy() for t in d.init_rv.get_stats()[:2])
    Q, R = d.noise_rv.get_stats()[1].numpy(), o.noise_rv.get_stats()[1].numpy()
    D = d.dim_state
    x = torch.as_tensor(rng.multivariate_normal(np.ravel(m0), np.reshape(P0, (D, D)), size=B))
    ys = []
    for k in range(T):
        q = rng.multivariate_normal(np.zeros(len(Q)), np.atleast_2d(Q), size=B)
        x = d.dyn_fcn(x, torch.as_tensor(q), k)
        r = torch.as_tensor(rng.multivariate_normal(np.zeros(len(R)), np.atleast_2d(R), size=B))
        ys.append(o.meas_fcn(o._select(x), r, k + 1))
    return torch.stack(ys, dim=-1)


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the step header cannot be built for the host")


#: (system, rule) of the warp form's host build
HOST_CASES = [("reentry", "gh3"), ("ct-b8", "gh3"), ("ct-b9", "gh3"), ("pend-copy", "gh16"),
              ("reentry-copy", "gh3"), ("ct-radar", "gpq-gh3")]


@pytest.fixture(scope="module")
def registered_host():
    """One g++ build of the registered kernel's source for the pendulum and
    radar copies in the warp form."""
    _need_gxx()
    return vf.build_registered([(_params(*c), vf._WARP) for c in (("pend-copy", "gh16"),
                                                                 ("reentry-copy", "gh3"))],
                               host=True)


@pytest.mark.parametrize("batch", [4, 5])
@pytest.mark.parametrize("case", HOST_CASES, ids="-".join)
def test_warp_form_on_host_matches_plain(registered_host, case, batch):
    """``vfl_step`` on 32 lanes built with g++ == the plain version with the
    C library's transcendentals, to the bit, all five streams, on 4
    trajectories and a ragged 5; measurements read through their strides
    (trajectory-major and time-major)."""
    params, ys = _params(*case), _simulate(case[0], batch, seed=batch)
    kernel = vf.kernel_of(params)
    assert kernel in ("vector_filter_general", "vector_filter_registered")
    want = vf._vector_filter_plain(params, ys, LIBM_FNS)
    time_major = ys.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    for y in (ys, time_major):
        for a, b in zip(vf._host_shim_run(params, y, kernel=kernel, lanes=vf._WARP), want):
            assert bool(torch.isfinite(b).all())
            assert torch.equal(a, b), f"max |diff| {float((a - b).abs().max()):.3e}"


def test_registered_radar_copy_equals_the_tables_radar(registered_host):
    """A registered measurement beside a table transition (no per-step
    streams): the registered kernel's warp form built with g++ gives the
    bits of the table's radar in the general kernel's warp form."""
    ys = _simulate("reentry", 4, seed=7)
    copy, table = _params("reentry-copy", "gh3"), _params("reentry", "gh3")
    assert (vf.kernel_of(copy), vf.kernel_of(table)) == ("vector_filter_registered",
                                                         "vector_filter_general")
    for a, b in zip(vf._host_shim_run(copy, ys), vf._host_shim_run(table, ys,
                                                                   kernel="vector_filter_general")):
        assert torch.equal(a, b), f"max |diff| {float((a - b).abs().max()):.3e}"


def test_warp_form_matches_jax_f64():
    """The warp form's host build on a record of reentry + radar under GH-3
    against the JAX package's float64 filter on the same measurements, all
    five streams at 1e-10, the tolerance of ``tests/test_torch_dd_lanes.py``."""
    _need_gxx()
    ys = _simulate("reentry", 4)
    jalg = RULES["gh3"][1](*_system("reentry", jax_side=True))
    ref = jax.jit(lambda b: st.gaussian_filter_batch(jalg.mod_dyn, jalg.mod_obs, jalg.tf_dyn,
                                                     jalg.tf_obs, b))(jnp.asarray(ys.numpy()))
    got = vf._host_shim_run(_params("reentry", "gh3"), ys, kernel="vector_filter_general",
                            lanes=vf._WARP)
    for f, g in zip(FIELDS, got):
        g = g.permute(2, 1, 0) if g.ndim == 3 else g.permute(3, 1, 2, 0)     # (B, ..., T)
        assert bool(torch.isfinite(g).all()), f
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(ref, f)), atol=1e-10,
                                   rtol=1e-10, err_msg=f)


W = vf._WARP
#: (system, rule) -> (kernel, lanes) the wrapper picks
ROUTES = [
    (("reentry", "gh3"), ("vector_filter_general", W)),
    (("ct-b4", "gh3"), ("vector_filter_general", W)),
    (("cv", "gh3"), ("vector_filter_slots", 0)),
    (("ct-radar", "gh3"), ("vector_filter_general", W)),
    (("ct-b5", "gh3"), ("vector_filter_general", W)),
    (("ct-b8", "gh3"), ("vector_filter_general", W)),
    (("ct-b9", "gh3"), ("vector_filter_general", W)),
    (("ct-b16", "gh3"), ("vector_filter_general", W)),
    (("ct-radar", "gpq-gh3"), ("vector_filter_general", W)),
    (("pend-copy", "gh16"), ("vector_filter_registered", W)),
    (("reentry-copy", "gh3"), ("vector_filter_registered", W)),
    (("falling", "gh3"), ("vector_filter_slots", 0)),
    (("reentry", "ukf/gh3"), ("vector_filter", 0)),
    (("pend-copy", "gh3"), ("vector_filter_registered", vf._SHAPED)),
    (("ct-radar", "ukf"), ("vector_filter_general", vf._SHAPED)),
]


@pytest.mark.parametrize("case,want", ROUTES, ids=["-".join(c) for c, _ in ROUTES])
def test_kernel_and_lanes_route_many_point_rules_to_the_warp_form(case, want):
    """Both rules of at least ``_WARP_MIN_POINTS`` points (GH-3 on 5-D
    states, GH-16 on a 2-D one, GPQ on GH-3 points) go to the warp form of
    the general or registered kernel, the five pairs' too (rules of fewer
    points keep their routes: constant velocity's 81 GH-3 points and the
    falling body's 27 the slot kernel, ``tests/test_torch_dd_slots.py``, a
    registered 2-D state's 9 the registered kernel's shaped form,
    ``tests/test_torch_dd_gh_shaped.py``, GH-3 beside the UKF the first
    version; CT + radar under the UKF the general kernel's shaped one-thread
    form, ``tests/test_torch_dd_shaped_general.py``)."""
    _need_gxx()
    params = _params(*case)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == want
    assert vf._warp_takes(params) == (want[1] == W)


#: the shared memory a block can take on sm_90, and an SM's, in bytes
BLOCK_SHARED, SM_SHARED = 232448, 233472


@pytest.mark.parametrize("case", [("reentry", "gh3"), ("ct-b8", "gh3"), ("ct-b16", "gh3"),
                                  ("ct-radar", "gpq-gh3"), ("cv", "gh3"), ("pend-copy", "gh16")],
                         ids="-".join)
def test_warp_fit_is_what_the_launcher_takes(case):
    """``vfl_fit_on`` in the warp form (``csrc/vector_filter_fit.cpp``, which
    ``lanes_of`` asks): a trajectory holds the lane-group layout with a tile
    of 32 points' offsets (33 apart; or a BQ rule's h) in place of every
    point's, its values and row sums on rows of an odd stride; of
    blocks of 16 down to 1 warps the one that lets an SM hold the most warps
    (beside 1 KB a block, at most 16 warps an SM, the launch bounds'), the
    rules staged unless that leaves an SM fewer than three quarters of the
    warps it holds without them."""
    _need_gxx()
    params = _params(*case)
    per_block, stage, size, warps = vf._form_fit(params, W)
    D, E, nd, no = params.dim_state, params.dim_out, params.dyn.n, params.obs.n
    dp, ep, wide = D | 1, E | 1, max(D, E)
    nf = max((nd | 1) * D, (no | 1) * E)
    bq = (params.dyn.kind | params.obs.kind) != 0
    assert size == (2 * D + E + 3 * D * dp + max(33 * D, wide * dp) + nf * (2 if bq else 1)
                    + wide * (wide + 1) // 2 + max(wide * dp, D * ep) + E * (E + 1) // 2
                    + D * ep)
    rules = E * E + sum((D + 2) * r.n if r.kind == 0 else (2 * D + 1 + r.n) * r.n
                        for r in (params.dyn, params.obs))

    def best(st_):
        out = (0, 0)
        for w in range(16, 0, -1):
            if (st_ + w * size) * 8 <= BLOCK_SHARED:
                n = min(SM_SHARED // ((st_ + w * size) * 8 + 1024), 16 // w) * w
                out = max(out, (n, w), key=lambda t: t[0])
        return out
    bare, staged = best(0), best(rules)
    assert (warps, per_block, stage) == ((*staged, rules) if staged[0] and
                                         4 * staged[0] >= 3 * bare[0] else (*bare, 0))
