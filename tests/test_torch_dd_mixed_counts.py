"""Mixed point counts in the shaped vector filter steps: the UKF (2 D + 1
points) on one transform beside the CKF (2 D) on the other, either way round,
with both counts template arguments (``vfs_step_with<D, E, ND, NO, ...>`` of
``csrc/vector_filter_shaped.cuh``).

- Host builds, to the bit against the plain version with the C library's
  transcendentals, all five streams, at 4 x 20: the classical shaped
  kernel's 10 mixed instantiations (``VFS_MIXED_OF`` of its five model
  pairs, ``vfs_host_run`` of ``csrc/vector_filter_shaped_host.cpp``) and the
  general kernel's shaped form's 24 (``VGS_MIXED``, the pairs of
  ``VGS_PAIRS``, ``vgs_host_run`` of
  ``csrc/vector_filter_general_shaped_host.cpp``), each g++ build once a
  module.
- Against the JAX package's float64 filter: reentry + radar (the classical
  shaped kernel) and CT + radar (the general kernel's shaped form) with the
  UKF on the dynamics and the CKF on the measurement, all five streams at
  1e-10, the tolerance of ``tests/test_torch_dd_pairs.py``.
- Routing: ``kernel_of`` / ``lanes_of`` on mixed classical counts (the
  shaped kernel, or the general kernel's shaped form), mixed counts beside a
  BQ rule (the kernel of the BQ shapes on its five pairs, the general
  one-thread form on the others), a registered
  configuration's mixed counts (the registered kernel's shaped form, which
  instantiates them as asked, for classical rules; beside a BQ rule its
  one-thread form), and the headers' instantiation lists as the routing
  sees them.

Measurements come from a numpy seed: 4 trajectories of 20 steps simulated
through the port's model functions with numpy noise; the same arrays go to
the JAX package.
"""
import math
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu import ssmod as jssmod
from ssmtoybox_tpu.ssinf import GaussianInference as JGaussianInference
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import set_device, ssmod
from ssmtoybox_torch.ops import KernelForm, forms, register_dyn_dd_vec
from ssmtoybox_torch.ops import vector_filter as vf
from ssmtoybox_torch.utils import GaussRV


class PendCopy(ssmod.Pendulum2DTransition):
    """The table's pendulum, registered with its own statements."""


def _pend_lower(model, n_steps):
    def plain(x, c, s, fns):
        x0, x1 = x.unbind(-1)
        return torch.stack([x0 + x1 * c[0], x1 - c[1] * fns.sin(x0)], -1)
    return [], KernelForm("f[0] = x[0] + x[1] * c[0];\nf[1] = x[1] - c[1] * sin(x[0]);",
                          (model.dt, model.g * model.dt), plain)


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port runs on the card unless told otherwise; these tests run it
    on the CPU, on one intra-op thread (the suite runs several workers at
    once), with the registered pendulum copy registered (unregistered when
    the module ends: the registry is a module global)."""
    set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    register_dyn_dd_vec(PendCopy, _pend_lower)
    yield
    forms.DYN_DD_VEC.pop(PendCopy, None)
    torch.set_num_threads(threads)
    set_device(None)


def _libm(fn):
    def apply(*ts):
        flat = [t.reshape(-1).tolist() for t in ts]
        out = torch.tensor([fn(*v) for v in zip(*flat)], dtype=torch.float64)
        return out.reshape(ts[0].shape)
    return apply


#: the C library's transcendentals, one value at a time: what a g++ build of
#: the step headers calls (PyTorch's vectorised CPU versions may be an ulp off)
LIBM_FNS = SimpleNamespace(
    sqrt=_libm(lambda v: math.sqrt(v) if v >= 0.0 or v != v else math.nan),
    exp=_libm(lambda v: math.exp(v) if v < 709.0 or v != v else math.inf),
    sin=_libm(math.sin), cos=_libm(math.cos), atan2=_libm(math.atan2))

FIELDS = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")
B, T = 4, 20

SENSORS = np.array([[0.0, 0.0], [200.0, 0.0], [0.0, 200.0], [200.0, 200.0]])
PEND_Q = 0.1 * np.array([[0.01 ** 3 / 3, 0.01 ** 2 / 2], [0.01 ** 2 / 2, 0.01]])

#: transition -> (state dimension, maker(new, rv)); ``new(cls)`` is a class's
#: constructor in either package, ``rv(d, mean, cov)`` its Gaussian
DYNS = {
    "reentry": (5, lambda new, rv: new("ReentryVehicle2DTransition")(
        rv(5, np.array([6500.4, 349.14, -1.8093, -6.7967, 0.6932]),
           np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0])),
        rv(3, None, np.diag([2.4064e-5, 2.4064e-5, 1e-6])), dt=0.05)),
    "cv": (4, lambda new, rv: new("ConstantVelocity")(
        rv(4, np.array([100.0, 10.0, 100.0, 5.0]), np.diag([10.0, 1.0, 10.0, 1.0])),
        rv(2, None, np.diag([0.5, 0.5])), dt=0.5)),
    "pendulum": (2, lambda new, rv: new("Pendulum2DTransition")(
        rv(2, np.array([1.5, 0.0]), 0.01 * np.eye(2)), rv(2, None, PEND_Q), dt=0.01)),
    "falling_body": (3, lambda new, rv: new("ReentryVehicle1DTransition")(
        rv(3, np.array([90.0, 6.0, 1.5]), 0.09 * np.eye(3)), rv(3, None, 1e-8 * np.eye(3)),
        dt=0.1)),
    "ct": (5, lambda new, rv: new("CoordinatedTurnTransition")(
        rv(5, np.array([100.0, 10.0, 100.0, 5.0, 0.06]), np.diag([10.0, 1.0, 10.0, 1.0, 1e-3])),
        rv(5, None, np.diag([0.1, 0.1, 0.1, 0.1, 1e-5])), dt=0.1)),
    "pend_copy": (2, lambda new, rv: PendCopy(rv(2, np.array([1.5, 0.0]), 0.01 * np.eye(2)),
                                              rv(2, None, 1e-4 * np.eye(2)), dt=0.01)),
}


def _pos(D):
    """The state components a planar measurement reads."""
    return [0, 2] if D >= 4 else [0, 1]


def _bearings(S):
    scale = lambda D: SENSORS[:S] / 100.0 - 1.0 if D == 2 else SENSORS[:S]  # noqa: E731
    return lambda new, rv, D: new("BearingMeasurement")(
        rv(S, None, 1e-3 * np.eye(S)), dim_state=D, state_index=_pos(D), sensor_pos=scale(D))


#: measurement -> maker(new, rv, D); ``re_radar`` is ``bench.py``'s radar of
#: the reentry vehicle (at the Earth's surface, reading the position)
OBS = {
    "sine": lambda new, rv, D: new("Pendulum2DMeasurement")(rv(1, None, 0.1 * np.eye(1)),
                                                            dim_state=D),
    "range": lambda new, rv, D: new("RangeMeasurement")(rv(1, None, 0.03 * np.eye(1)),
                                                        dim_state=D),
    "ungm": lambda new, rv, D: new("UNGMMeasurement")(rv(1, None, 1.0 * np.eye(1)), dim_state=D,
                                                      state_index=[0]),
    "radar": lambda new, rv, D: new("Radar2DMeasurement")(
        rv(2, None, np.diag([1.0, 1e-4])), dim_state=D, state_index=_pos(D),
        radar_loc=np.array([-5.0, -5.0])),
    "re_radar": lambda new, rv, D: new("Radar2DMeasurement")(
        rv(2, None, np.diag([1e-3, 1e-5])), dim_state=D, state_index=[0, 1],
        radar_loc=np.array([6374.0, 0.0])),
    **{f"b{S}": _bearings(S) for S in (2, 3, 4)},
}


def _system(dyn, obs, jax_side=False):
    """(transition, measurement) in the port or the JAX package."""
    if jax_side:
        new, rv = (lambda cls: getattr(jssmod, cls).create), (
            lambda d, m, c: JGaussRV.create(d, mean=m, cov=c))
    else:
        new, rv = (lambda cls: getattr(ssmod, cls)), (lambda d, m, c: GaussRV(d, mean=m, cov=c))
    D, make = DYNS[dyn]
    return make(new, rv), OBS[obs](new, rv, D)


def _kpar(D):
    return np.array([[1.0] + [3.0] * D])


#: rule -> a filter of it in either package (``pkg``: ``stt`` or ``st``)
RULES = {
    "ukf": lambda pkg, d, o: pkg.UnscentedKalman(d, o),
    "ckf": lambda pkg, d, o: pkg.CubatureKalman(d, o),
    "gpq": lambda pkg, d, o: pkg.GaussianProcessKalman(d, o, _kpar(d.dim_state),
                                                       _kpar(d.dim_state)),
}


def _filter(dyn, obs, rules, jax_side=False):
    """The port's (or the JAX package's) Gaussian filter of the system with
    the rules ``"DYN/OBS"``: the first on the dynamics, the second on the
    measurement."""
    pkg, inference = (st, JGaussianInference) if jax_side else (stt, stt.GaussianInference)
    d, o = _system(dyn, obs, jax_side)
    a, b = rules.split("/")
    return inference(d, o, RULES[a](pkg, d, o).tf_dyn, RULES[b](pkg, d, o).tf_obs)


def _params(dyn, obs, rules):
    alg = _filter(dyn, obs, rules)
    return vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)


def _simulate(dyn, obs, seed=0):
    """(B, E, T) measurements simulated with numpy noise through the port's
    model functions (truth from step 0, measurement k of the state at step
    k)."""
    d, o = _system(dyn, obs)
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
        pytest.skip("g++ is not installed: the step headers cannot be built for the host")


#: the model pairs of the classical shaped kernel (``VFS_PAIRS`` of
#: ``csrc/vector_filter_shaped.cuh``) and of the general kernel's shaped form
#: (``VGS_PAIRS`` of ``csrc/vector_filter_general_shaped.cuh``)
SHAPED_PAIRS = [("reentry", "re_radar"), ("cv", "radar"), ("pendulum", "sine"),
                ("falling_body", "range"), ("ct", "b4")]
GENERAL_PAIRS = [("ct", "radar"), ("ct", "b2"), ("ct", "b3"), ("pendulum", "radar"),
                 ("pendulum", "ungm"), ("pendulum", "b3"), ("falling_body", "sine"),
                 ("falling_body", "b4"), ("cv", "b2"), ("cv", "b3"), ("reentry", "range"),
                 ("reentry", "ungm")]
#: the mixed orders: the UT count on the dynamics and the CKF count on the
#: measurement, and the other way round
ORDERS = ["ukf/ckf", "ckf/ukf"]


@pytest.fixture(scope="module")
def hosts():
    """One g++ build each, at once, of the classical shaped kernel's step
    (its 20 instantiations) and of the general kernel's shaped form (its
    48)."""
    _need_gxx()
    with ThreadPoolExecutor(2) as pool:
        return [job.result() for job in [pool.submit(vf._shaped_host),
                                         pool.submit(vf._general_shaped_host)]]


def _held_to_plain(params, ys):
    """The host build of ``params``' route against the plain version with
    the C library's transcendentals, to the bit, all five streams, the
    measurements read batch-major and time-major."""
    want = vf._vector_filter_plain(params, ys, LIBM_FNS)
    time_major = ys.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    for y in (ys, time_major):
        for f, a, b in zip(FIELDS, vf._host_shim_run(params, y, kernel=vf.kernel_of(params)),
                           want):
            assert bool(torch.isfinite(b).all()), f
            assert torch.equal(a, b), f"{f}: max |diff| {float((a - b).abs().max()):.3e}"


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("pair", SHAPED_PAIRS, ids="-".join)
def test_shaped_kernel_mixed_counts_on_host_match_plain(hosts, pair, order):
    """The classical shaped kernel's mixed instantiations (``VFS_MIXED_OF``:
    2 D + 1 points on one transform, 2 D on the other) built with g++ ==
    the plain version, to the bit, all five streams, on each of its five
    model pairs."""
    params = _params(*pair, order)
    D = params.dim_state
    assert (params.dyn.n, params.obs.n) == ((2 * D + 1, 2 * D) if order == "ukf/ckf" else
                                            (2 * D, 2 * D + 1))
    assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_shaped", 0)
    _held_to_plain(params, _simulate(*pair, seed=1))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("pair", GENERAL_PAIRS, ids="-".join)
def test_general_shaped_form_mixed_counts_on_host_match_plain(hosts, pair, order):
    """The general kernel's shaped form at mixed counts (``VGS_MIXED``,
    ``csrc/vector_filter_general_shaped_mixed.cu``) built with g++ == the
    plain version, to the bit, all five streams, on every pair of
    ``VGS_PAIRS``; each transform's point loops rolled or unrolled on its
    own count."""
    params = _params(*pair, order)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_general", vf._SHAPED)
    _held_to_plain(params, _simulate(*pair, seed=2))


@pytest.mark.parametrize("pair", [("reentry", "re_radar"), ("ct", "radar")], ids="-".join)
def test_mixed_counts_match_jax_f64(hosts, pair):
    """Reentry + radar (the classical shaped kernel) and CT + radar (the
    general kernel's shaped form) with the UKF on the dynamics and the CKF
    on the measurement: the host build against the JAX package's float64
    filter with the same two transforms on the same measurements, all five
    streams at 1e-10 (``tests/test_torch_dd_pairs.py``'s tolerance)."""
    ys = _simulate(*pair, seed=3)
    jalg = _filter(*pair, "ukf/ckf", jax_side=True)
    ref = jax.jit(lambda b: st.gaussian_filter_batch(jalg.mod_dyn, jalg.mod_obs, jalg.tf_dyn,
                                                     jalg.tf_obs, b))(jnp.asarray(ys.numpy()))
    params = _params(*pair, "ukf/ckf")
    got = vf._host_shim_run(params, ys, kernel=vf.kernel_of(params))
    for f, g in zip(FIELDS, got):
        g = g.permute(2, 1, 0) if g.ndim == 3 else g.permute(3, 1, 2, 0)     # (B, ..., T)
        assert bool(torch.isfinite(g).all()), f
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(ref, f)), atol=1e-10,
                                   rtol=1e-10, err_msg=f)


#: (transition, measurement, rules) -> (kernel, lanes) the wrapper picks
ROUTES = [
    (("reentry", "re_radar", "ukf/ckf"), ("vector_filter_shaped", 0)),
    (("reentry", "re_radar", "ckf/ukf"), ("vector_filter_shaped", 0)),
    (("ct", "b4", "ukf/ckf"), ("vector_filter_shaped", 0)),
    (("ct", "radar", "ukf/ckf"), ("vector_filter_general", vf._SHAPED)),
    (("ct", "b3", "ckf/ukf"), ("vector_filter_general", vf._SHAPED)),
    (("reentry", "re_radar", "gpq/ckf"), ("vector_filter_shaped_bq", 0)),  # BQ, mixed counts
    (("reentry", "re_radar", "ukf/ukf"), ("vector_filter_shaped", 0)),
    (("reentry", "re_radar", "gpq/ukf"), ("vector_filter_shaped_bq", 0)),
    (("ct", "radar", "gpq/ckf"), ("vector_filter_general", 0)),
    (("ct", "radar", "ckf/gpq"), ("vector_filter_general", 0)),
    (("pend_copy", "radar", "ukf/ckf"), ("vector_filter_registered", vf._SHAPED)),
    (("pend_copy", "radar", "ukf/ukf"), ("vector_filter_registered", vf._SHAPED)),
    (("pend_copy", "radar", "gpq/ckf"), ("vector_filter_registered", 0)),
    (("pend_copy", "radar", "ckf/gpq"), ("vector_filter_registered", 0)),
    (("pend_copy", "radar", "gpq/gpq"), ("vector_filter_registered", vf._SHAPED)),
]


@pytest.mark.parametrize("case,want", ROUTES, ids=["-".join(c) for c, _ in ROUTES])
def test_routes_of_mixed_counts(case, want):
    """Two classical rules at the UT and CKF counts, mixed either way round,
    go to the classical shaped kernel on its five pairs and to the general
    kernel's shaped form on the pairs of ``VGS_PAIRS``; a BQ rule beside a
    rule of the other count goes to the kernel of the BQ shapes on its five
    pairs (the general one-thread form on the others); a registered
    configuration takes its shaped form at mixed counts of classical rules
    too, and keeps its one-thread form for a BQ rule beside the other
    count."""
    _need_gxx()
    params = _params(*case)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == want


#: the step header's model ids, by macro name
VF_IDS = {**{f"VF_DYN_{k}": i for i, k in enumerate(("REENTRY", "CV", "PENDULUM", "REENTRY1D",
                                                    "CT"))},
          **{f"VF_OBS_{k}": i for i, k in enumerate(("RADAR", "PENDULUM_SIN", "RANGE", "BEARING",
                                                    "UNGM"))}}


def _listed(name, macro, further=0):
    """``(D, E, dynamics id, measurement id)`` and the next ``further``
    integer fields of the entries of ``macro`` in the header ``name``: its
    ``X(F, D, E, DYN, OBS)`` entries where it takes ``(X, F)``, else its
    ``F(D, E, DYN, OBS, ...)``."""
    src = open(f"{vf._build.CSRC}/{name}").read()
    pairs = f"#define {macro}(X, F)" in src
    body = src.split(f"#define {macro}({'X, F' if pairs else 'F'})")[1].split("\n\n")[0]
    head = r"X\(F, " if pairs else r"F\("
    return {(int(m[1]), int(m[2]), VF_IDS[m[3]], VF_IDS[m[4]],
             *(int(v) for v in m[5].split(", ")[1:further + 1]))
            for m in re.finditer(head + r"(\d), (\d), (\w+), (\w+)((?:, \w+)*)\)", body)}


def test_the_routing_sees_the_headers_mixed_instantiations():
    """The headers instantiate the mixed counts of every pair they list
    (``VFS_MIXED_OF`` in ``VFS_SHAPES``, ``VGS_MIXED`` in the sixth source,
    which ``SOURCES`` builds), and the routing sends the UKF beside the CKF,
    either way round, to the classical shaped kernel exactly on the pairs of
    ``VFS_PAIRS`` and to the general kernel's shaped form exactly on those of
    ``VGS_PAIRS`` (asking the header, ``vgs_takes_on``), over every table
    pair of up to 4 outputs."""
    _need_gxx()
    shaped = open(f"{vf._build.CSRC}/vector_filter_shaped.cuh").read()
    assert re.search(r"#define VFS_MIXED_OF\(F, D, E, DYN, OBS\) \\\n"
                     r"  F\(D, E, DYN, OBS, 2 \* \(D\) \+ 1, 2 \* \(D\)\) "
                     r"F\(D, E, DYN, OBS, 2 \* \(D\), 2 \* \(D\) \+ 1\)", shaped)
    assert "#define VFS_SHAPES(F) VFS_PAIRS(VFS_SHAPES_OF, F) VFS_PAIRS(VFS_MIXED_OF, F)" in shaped
    general = open(f"{vf._build.CSRC}/vector_filter_general_shaped.cuh").read()
    assert "#define VGS_MIXED(F) VGS_PAIRS(VFS_MIXED_OF, F)" in general
    mixed = open(f"{vf._build.CSRC}/vector_filter_general_shaped_mixed.cu").read()
    assert "VGS_MIXED(VGS_LAUNCH_IF)" in mixed
    assert "vector_filter_general_shaped_mixed.cu" in vf.SOURCES
    want = {"vector_filter_shaped": _listed("vector_filter_shaped.cuh", "VFS_PAIRS"),
            "vector_filter_general": _listed("vector_filter_general_shaped.cuh", "VGS_PAIRS")}
    assert (len(want["vector_filter_shaped"]), len(want["vector_filter_general"])) == (5, 12)
    taken = {k: set() for k in want}
    for dyn in ("reentry", "cv", "pendulum", "falling_body", "ct"):
        for obs in ("sine", "range", "ungm", "radar", "b2", "b3", "b4"):
            for order in ORDERS:
                p = _params(dyn, obs, order)
                kernel, lanes = vf.kernel_of(p), vf.lanes_of(p)
                if (kernel, lanes) in (("vector_filter_shaped", 0),
                                       ("vector_filter_general", vf._SHAPED)):
                    taken[kernel].add((p.dim_state, p.dim_out, p.dyn_model, p.obs_model))
    assert taken == want
