"""The lane-group form of the general and registered vector filter kernels
(``vfl_step`` in ``csrc/vector_filter_lanes.cuh``): a trajectory on G lanes
of a warp (``VFL_G``, 8; a build may set 4), its arrays in shared memory,
the work split by entry so that it gives the one-thread step's bits.
``ops.vector_filter.lanes_of`` sends it the shapes where the E x E and D x D
algebra dominates: more than 4 measurement outputs, or a registered state
of more than 5 dimensions.

- Host build: the lane-group step compiled with g++ (``vector_filter_host.cpp``,
  the lanes of a phase run one after another, a trajectory's shared memory a
  host buffer filled with NaN first, the rules staged in another as a block
  stages them) equals the plain version with the C
  library's transcendentals, to the bit, at G = 8 and, built with
  ``-DVFL_G=4``, at 4: CT with 5, 8, 9 and 16 bearings under the CKF, CT
  with 12 bearings under GPQ, and a registered 8-D chain with the radar
  (the chain also in the one-thread form).
- Against the JAX package's float64 filter: the lane-group step on a record
  of CT with 16 bearings, all five streams at 1e-10.
- Routing: ``lanes_of`` and ``kernel_of`` on the shapes of both kernels, and
  a shape whose arrays do not fit in a block's shared memory, which keeps the
  one-thread form; the header's fit (``csrc/vector_filter_fit.cpp``) that
  ``lanes_of`` asks.

Measurements come from a numpy seed: 4 trajectories of 20 steps simulated
through the port's model functions with numpy noise.
"""
import math
import shutil
from types import SimpleNamespace

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
from ssmtoybox_torch.ops import KernelForm, _build, forms, register_dyn_dd_vec
from ssmtoybox_torch.ops import vector_filter as vf
from ssmtoybox_torch.utils import GaussRV


class Chain8D(ssmod.TransitionModel):
    """Four coupled pendulums, 8 states (``chip_smoke.py``'s registry lane)."""
    dim_state, dim_noise = 8, 8
    DT, W, K = 0.05, 2.0, 0.5

    def dyn_fcn(self, x, q, time):
        p, v = x[..., 0::2], x[..., 1::2]
        nxt = torch.roll(p, -1, dims=-1)
        f = torch.stack([p + self.DT * v,
                         v - self.DT * (self.W * torch.sin(p) - self.K * (nxt - p))], -1)
        return f.reshape(x.shape) + q


def _chain_lower(model, n_steps):
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


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port runs on the card unless told otherwise; these tests run it
    on the CPU, on one intra-op thread (the suite runs several workers at
    once), with the chain registered (unregistered when the module ends:
    the registry is a module global)."""
    set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    register_dyn_dd_vec(Chain8D, _chain_lower)
    yield
    forms.DYN_DD_VEC.pop(Chain8D, None)
    torch.set_num_threads(threads)
    set_device(None)


def _libm(fn):
    def apply(*ts):
        flat = [t.reshape(-1).tolist() for t in ts]
        out = torch.tensor([fn(*v) for v in zip(*flat)], dtype=torch.float64)
        return out.reshape(ts[0].shape)
    return apply


#: the C library's transcendentals, one value at a time: what a g++ build of
#: the step header calls (PyTorch's vectorised CPU versions may be an ulp off)
LIBM_FNS = SimpleNamespace(
    sqrt=_libm(lambda v: math.sqrt(v) if v >= 0.0 or v != v else math.nan),
    exp=_libm(lambda v: math.exp(v) if v < 709.0 or v != v else math.inf),
    sin=_libm(math.sin), cos=_libm(math.cos), atan2=_libm(math.atan2))

FIELDS = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")
B, T = 4, 20

#: 16 sensors on a circle of radius 150 about (100, 100), where the turning
#: target of ``CT_M0`` starts (``chip_smoke.REG_SENSORS``)
SENSORS = np.array([[100.0 + 150.0 * math.cos(0.2 + 2 * math.pi * i / 16),
                     100.0 + 150.0 * math.sin(0.2 + 2 * math.pi * i / 16)] for i in range(16)])
CT_M0, CT_P0 = np.array([100.0, 10.0, 100.0, 5.0, 0.06]), np.diag([10.0, 1.0, 10.0, 1.0, 1e-3])


def _system(name, jax_side=False):
    """(transition, measurement) in the port or the JAX package: ``ct-b<S>``,
    CT with S bearings; ``chain``, the registered 8-D chain with the radar
    (the port only); ``pendulum``, the table's pendulum with the radar."""
    if jax_side:
        new, rv = (lambda cls: getattr(jssmod, cls).create), (
            lambda d, m, c: JGaussRV.create(d, mean=m, cov=c))
    else:
        new, rv = (lambda cls: getattr(ssmod, cls)), (lambda d, m, c: GaussRV(d, mean=m, cov=c))
    if name.startswith("ct-b"):
        S = int(name[4:])
        d = new("CoordinatedTurnTransition")(rv(5, CT_M0, CT_P0),
                                             rv(5, None, np.diag([0.1, 0.1, 0.1, 0.1, 1e-5])),
                                             dt=0.1)
        return d, new("BearingMeasurement")(rv(S, None, 1e-3 * np.eye(S)), dim_state=5,
                                            state_index=[0, 2], sensor_pos=SENSORS[:S])
    radar = new("Radar2DMeasurement")
    if name == "chain":
        d = Chain8D(rv(8, np.tile([0.5, 0.0], 4), 0.05 * np.eye(8)), rv(8, None, 1e-4 * np.eye(8)))
        return d, radar(rv(2, None, np.diag([0.01, 1e-3])), dim_state=8, state_index=[0, 2],
                        radar_loc=np.array([-3.0, -3.0]))
    d = new("Pendulum2DTransition")(rv(2, np.array([1.5, 0.0]), 0.01 * np.eye(2)),
                                    rv(2, None, 1e-4 * np.eye(2)), dt=0.01)
    return d, radar(rv(2, None, np.diag([0.01, 1e-3])), dim_state=2, state_index=[0, 1],
                    radar_loc=np.array([-2.0, -2.0]))


def _kpar(D):
    return np.array([[1.0] + [3.0] * D])


#: rule -> (maker in the port, maker in the JAX package)
RULES = {
    "ukf": (lambda d, o: stt.UnscentedKalman(d, o), lambda d, o: st.UnscentedKalman(d, o)),
    "ckf": (lambda d, o: stt.CubatureKalman(d, o), lambda d, o: st.CubatureKalman(d, o)),
    "gh3": (lambda d, o: stt.GaussHermiteKalman(d, o, deg=3),
            lambda d, o: st.GaussHermiteKalman(d, o, deg=3)),
    "gpq": (lambda d, o: stt.GaussianProcessKalman(d, o, _kpar(d.dim_state), _kpar(d.dim_state)),
            lambda d, o: st.GaussianProcessKalman(d, o, _kpar(d.dim_state), _kpar(d.dim_state),
                                                  points="ut")),
}


def _params(name, rule):
    alg = RULES[rule][0](*_system(name))
    return vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)


def _simulate(name, seed=0):
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


@pytest.fixture(scope="module")
def registered_host():
    """One g++ build of the registered kernel's source for the chain in its
    two forms (one thread a trajectory, the lane-group form)."""
    _need_gxx()
    p = _params("chain", "ckf")
    return vf.build_registered([(p, g) for g in (0, vf._LANES)], host=True)


@pytest.fixture(scope="module")
def four_lanes():
    """g++ builds with the lane-group form on 4 lanes a trajectory
    (``-DVFL_G=4``): the general step's library, and the chain's registered
    library as ``(key, (library, index))``."""
    _need_gxx()
    general = _build.bound("vector_filter_host_g4", ["vector_filter_host.cpp"], vf._bind_host,
                           ["-DVFL_G=4"], host=True)
    p, built = _params("chain", "ckf"), {}
    key = (8, 0, 4, vf._model_policy(p, "VfrPair", 0))
    forms.build_generated(built, [key], vf._registered_header([key]),
                          name="vector_filter_registered_host_g4",
                          source="vector_filter_host.cpp", file="vfr_forms.cuh",
                          bind=vf._bind_registered_host,
                          flags=["-DVFR_REGISTERED", "-DVFL_G=4"], host=True)
    return general, (True, key), built[True, key]


#: (system, rule) of the lane-group form's host build
HOST_CASES = [("ct-b5", "ckf"), ("ct-b8", "ckf"), ("ct-b9", "ckf"), ("ct-b16", "ckf"),
              ("ct-b12", "gpq"), ("chain", "ckf")]


@pytest.mark.parametrize("lanes", [4, 8])
@pytest.mark.parametrize("case", HOST_CASES, ids="-".join)
def test_lane_form_on_host_matches_plain(registered_host, four_lanes, monkeypatch, case, lanes):
    """``vfl_step`` on 4 or 8 lanes built with g++ == the plain version with
    the C library's transcendentals, to the bit, all five streams;
    measurements read through their strides.  On 4 lanes the wrapper's host
    run goes to the ``-DVFL_G=4`` builds."""
    params, ys = _params(*case), _simulate(case[0], seed=1)
    assert vf.lanes_of(params) == vf._LANES
    if lanes == 4:
        general, key, entry = four_lanes
        monkeypatch.setattr(vf, "_host_shim", lambda: general)
        monkeypatch.setitem(vf._REGISTERED, key, entry)
    want = vf._vector_filter_plain(params, ys, LIBM_FNS)
    time_major = ys.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    for y in (ys, time_major):
        for a, b in zip(vf._host_shim_run(params, y, lanes=lanes), want):
            assert bool(torch.isfinite(b).all())
            assert torch.equal(a, b), f"max |diff| {float((a - b).abs().max()):.3e}"


def test_registered_one_thread_form_on_host_matches_plain(registered_host):
    """The registered 8-D chain in the one-thread form, which keeps the
    shapes whose arrays do not fit in shared memory: g++ build == the plain
    version, to the bit."""
    params, ys = _params("chain", "ckf"), _simulate("chain", seed=2)
    for a, b in zip(vf._host_shim_run(params, ys, lanes=0),
                    vf._vector_filter_plain(params, ys, LIBM_FNS)):
        assert torch.equal(a, b), f"max |diff| {float((a - b).abs().max()):.3e}"


def test_lane_form_matches_jax_f64():
    """The lane-group step's host build on a record of CT with 16 bearings
    (CKF) against the JAX package's float64 filter on the same measurements,
    all five streams at 1e-10, the tolerance of ``tests/test_torch_dd_wide.py``."""
    _need_gxx()
    ys = _simulate("ct-b16")
    jalg = RULES["ckf"][1](*_system("ct-b16", jax_side=True))
    ref = jax.jit(lambda b: st.gaussian_filter_batch(jalg.mod_dyn, jalg.mod_obs, jalg.tf_dyn,
                                                     jalg.tf_obs, b))(jnp.asarray(ys.numpy()))
    params = _params("ct-b16", "ckf")
    got = vf._host_shim_run(params, ys, lanes=vf._LANES)
    for f, g in zip(FIELDS, got):
        g = g.permute(2, 1, 0) if g.ndim == 3 else g.permute(3, 1, 2, 0)     # (B, ..., T)
        assert bool(torch.isfinite(g).all()), f
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(ref, f)), atol=1e-10,
                                   rtol=1e-10, err_msg=f)


#: (system, rule) -> (kernel, lanes) the wrapper picks
ROUTES = [
    (("pendulum", "ukf"), ("vector_filter_general", vf._SHAPED)),
    (("ct-b2", "ckf"), ("vector_filter_general", vf._SHAPED)),
    (("ct-b3", "ckf"), ("vector_filter_general", vf._SHAPED)),
    (("ct-b4", "ckf"), ("vector_filter_shaped", 0)),
    (("ct-b4", "gh3"), ("vector_filter_general", vf._WARP)),
    (("ct-b5", "ckf"), ("vector_filter_general", vf._LANES)),
    (("ct-b8", "gpq"), ("vector_filter_general", vf._LANES)),
    (("ct-b16", "ukf"), ("vector_filter_general", vf._LANES)),
    (("chain", "ckf"), ("vector_filter_registered", vf._LANES)),
    (("chain", "gh3"), ("vector_filter_registered", 0)),
    (("ct-b5", "gh3"), ("vector_filter_general", vf._WARP)),
    (("ct-b8", "gh3"), ("vector_filter_general", vf._WARP)),
    (("ct-b9", "gh3"), ("vector_filter_general", vf._WARP)),
]


@pytest.mark.parametrize("case,want", ROUTES, ids=["-".join(c) for c, _ in ROUTES])
def test_lanes_of_routes_by_shape(case, want):
    """One thread a trajectory up to 4 outputs on states of up to 5
    dimensions (the shaped one-thread form at the UT and CKF counts of the
    pairs it instantiates, ``tests/test_torch_dd_shaped_general.py``) and
    for the other kernels; the lane-group form above, except where a
    warp's trajectories' arrays do not fit in a block's shared memory (the
    8-D chain under GH-3: 6,561 points) and, up to 8 outputs, where an SM
    holds fewer than 4 warps of it; Gauss-Hermite rules of 243 points (CT
    with 4, 5, 8 and 9 bearings under GH-3) in the warp form (a trajectory
    on a whole warp, ``tests/test_torch_dd_warp.py``), of the general kernel
    also for CT with 4 bearings, which the first version ran before."""
    _need_gxx()
    params = _params(*case)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == want
    if case == ("chain", "gh3"):
        assert vf._form_fit(params, vf._LANES)[0] == 0


#: the shared memory a block can take on sm_90, and an SM's, in bytes
BLOCK_SHARED, SM_SHARED = 232448, 233472


@pytest.mark.parametrize("case", [("ct-b16", "ckf"), ("ct-b12", "gpq"), ("chain", "ckf"),
                                  ("chain", "gh3"), ("pendulum", "gh3"), ("ct-b9", "ukf"),
                                  ("ct-b5", "gh3"), ("ct-b9", "gh3")],
                         ids="-".join)
def test_lane_fit_is_what_the_launcher_takes(case):
    """``csrc/vector_filter_fit.cpp``, which ``lanes_of`` asks: a block holds
    two warps' trajectories (8 lanes each) where they fit beside the staged
    rules in a block's shared memory, one warp's where only that fits, none
    where not even that fits (the launcher refuses those); both rules and R
    are staged up to 8,192 doubles, none above (the 8-D chain's 6,561 GH-3
    points); an SM holds as many such blocks as its shared memory (beside 1 KB
    a block) and the launch bounds' 10 blocks allow; and ``lanes_of`` takes
    the lane-group form exactly where the shape is one it routes there and
    an SM holds a warp of it, 4 up to 8 outputs, where the warp form does
    not take the shape (``_warp_takes``: CT under GH-3); up to 4 outputs the
    shaped one-thread form where it takes the shape (``_shaped_takes``: the
    pendulum + radar under GH-3, 9 points, since it takes Gauss-Hermite
    counts of at most 11)."""
    _need_gxx()
    params = _params(*case)
    block, stage, doubles, sm_warps = vf._form_fit(params, vf._LANES)
    D, E = params.dim_state, params.dim_out
    rules = E * E + sum((D + 2) * r.n if r.kind == 0 else (2 * D + 1 + r.n) * r.n
                        for r in (params.dyn, params.obs))
    assert stage == (rules if rules <= 8192 else 0)
    assert (stage == 0) == (case == ("chain", "gh3"))
    fits = [w * 4 for w in (2, 1) if (stage + w * 4 * doubles) * 8 <= BLOCK_SHARED]
    assert block == (fits[0] if fits else 0)
    blocks = min(10, SM_SHARED // ((stage + block * doubles) * 8 + 1024)) if block else 0
    warps = blocks * block * 8 // 32
    assert sm_warps == warps
    takes = vf.kernel_of(params) in ("vector_filter_general", "vector_filter_registered")
    wants = takes and (E > 4 or D > 5) and warps >= (vf._MIN_LANE_WARPS if E <= 8 else 1)
    assert vf.lanes_of(params) == (vf._WARP if vf._warp_takes(params) else
                                   vf._LANES if wants else
                                   vf._SHAPED if takes and vf._shaped_takes(params) else 0)


@pytest.mark.parametrize("sensors", [5, 16])
def test_lane_form_needs_no_scratch_buffer(sensors):
    """The lane-group form keeps its arrays in shared memory: its launches
    take an empty scratch buffer; the one-thread form's scratch holds the
    function values, and beside them the wide form's E-sized arrays from 9
    outputs on."""
    params = _params(f"ct-b{sensors}", "ckf")
    assert vf._scratch(params, 3, "cpu", vf._LANES).numel() == 0
    n, D, S = 10, 5, sensors
    wide = 2 * S + 2 * S * S + 4 * D * S if S > 8 else 0
    assert vf._scratch(params, 3, "cpu").numel() == 3 * (max(n * D, n * S) + wide)
