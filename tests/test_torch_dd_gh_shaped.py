"""Gauss-Hermite counts of at most 11 points in the shaped vector filter
steps (``vfs_gh_count`` of ``csrc/vector_filter_shaped.cuh``: GH-3 on a 2-D
state, 9 points; GH-2 on a 3-D one, 8), both rules classical at that count,
and the registered shaped form at mixed point counts.

- Host builds, to the bit against the plain version with the C library's
  transcendentals, all five streams, at ragged batches (1 and 4
  trajectories, 20 steps): the classical shaped kernel's Gauss-Hermite
  instantiations (``VFS_GH``: the pendulum at 9 points, the falling body at
  8; ``vfs_host_run``), the general kernel's shaped form's (``VGS_GH``, the
  five pairs of 2-D and 3-D states of ``VGS_PAIRS``; ``vgs_host_run``), and
  a registered driven pendulum with the table's radar in the registered
  kernel's shaped form under GH-3 and under the UKF beside the CKF
  (``vfr_shaped_host_run``; the mixed counts instantiated as asked).
- Against the JAX package's float64 filter: the pendulum + radar under GH-3
  (the general kernel's shaped form), 4 x 20, all five streams at 1e-10,
  the tolerance of ``tests/test_torch_dd_mixed_counts.py``.
- Routing: ``kernel_of`` / ``lanes_of`` on the Gauss-Hermite counts (and the
  BQ rules at them, which keep their routes), and the headers' lists
  (``VFS_GH``, ``VGS_GH``) as the routing sees them.

Measurements come from a numpy seed (``tests/test_torch_dd_mixed_counts.py``'s
simulation through the port's model functions); the same arrays go to the
JAX package.
"""
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
import ssmtoybox_torch as stt
from ssmtoybox_torch import set_device, ssmod
from ssmtoybox_torch.ops import KernelForm, forms, register_dyn_dd_vec
from ssmtoybox_torch.ops import vector_filter as vf
from ssmtoybox_torch.utils import GaussRV

from test_torch_dd_mixed_counts import (FIELDS, LIBM_FNS, _listed, _need_gxx, _simulate,
                                        _system)


class Driven2D(ssmod.TransitionModel):
    """A driven pendulum, ``[x0 + dt x1, x1 - w dt sin(x0) + dt u_t]``, ``u_t
    = 0.5 sin(0.1 t)`` a per-step stream (``chip_smoke.py``'s registry
    lane)."""
    dim_state, dim_noise = 2, 2
    DT, W = 0.05, 4.0

    def dyn_fcn(self, x, q, time):
        x0, x1 = x.unbind(-1)
        u = 0.5 * math.sin(0.1 * time)
        return torch.stack([x0 + self.DT * x1,
                            x1 - (self.W * self.DT) * torch.sin(x0) + self.DT * u], -1) + q


def _driven_lower(model, n_steps):
    def plain(x, c, s, fns):
        x0, x1 = x.unbind(-1)
        return torch.stack([x0 + c[0] * x1, x1 - c[1] * fns.sin(x0) + c[0] * s[0]], -1)
    return [0.5 * np.sin(0.1 * np.arange(n_steps))], KernelForm(
        "f[0] = x[0] + c[0] * x[1];\nf[1] = x[1] - c[1] * sin(x[0]) + c[0] * s[0];",
        (model.DT, model.W * model.DT), plain)


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port runs on the card unless told otherwise; these tests run it
    on the CPU, on one intra-op thread (the suite runs several workers at
    once), with the driven pendulum registered (unregistered when the module
    ends: the registry is a module global)."""
    set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    register_dyn_dd_vec(Driven2D, _driven_lower)
    yield
    forms.DYN_DD_VEC.pop(Driven2D, None)
    torch.set_num_threads(threads)
    set_device(None)


def _driven():
    """The driven pendulum with the table's radar: (dynamics, measurement)."""
    return (Driven2D(GaussRV(2, mean=[1.0, 0.0], cov=0.1 * np.eye(2)),
                     GaussRV(2, cov=1e-3 * np.eye(2))),
            ssmod.Radar2DMeasurement(GaussRV(2, cov=np.diag([0.01, 1e-3])), dim_state=2,
                                     state_index=[0, 1], radar_loc=np.array([-2.0, -2.0])))

#: rule name -> a filter of it on (dyn, obs)
RULES = {"ukf": stt.UnscentedKalman, "ckf": stt.CubatureKalman,
         **{f"gh{d}": (lambda d: lambda dyn, obs: stt.GaussHermiteKalman(dyn, obs, deg=d))(d)
            for d in (2, 3, 4)},
         "gpq-gh3": lambda dyn, obs: stt.GaussianProcessKalman(
             dyn, obs, np.array([[1.0, 3.0, 3.0]]), np.array([[1.0, 3.0, 3.0]]), points="gh",
             point_hyp={"degree": 3})}


def _params(dyn, obs, rules):
    """``vf.prepare`` of the table's system ``(dyn, obs)`` (names of
    ``tests/test_torch_dd_mixed_counts.py``) or of the driven pendulum
    (``"driven"``) under ``"DYN/OBS"`` rules (one name: both)."""
    d, o = _driven() if dyn == "driven" else _system(dyn, obs)
    a, _, b = rules.partition("/")
    return vf.prepare(d, o, RULES[a](d, o).tf_dyn, RULES[b or a](d, o).tf_obs)


@pytest.fixture(scope="module")
def hosts():
    """The g++ builds at once: the classical shaped kernel's step, the
    general kernel's shaped form and the registered driven pendulum's two
    shaped configurations."""
    _need_gxx()
    registered = [_params("driven", None, "gh3"), _params("driven", None, "ukf/ckf")]
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(vf._shaped_host), pool.submit(vf._general_shaped_host),
                pool.submit(vf.build_registered, registered, True)]
        return [job.result() for job in jobs]


def _held_to_plain(params, ys, kernel):
    """The host build of ``kernel`` against the plain version with the C
    library's transcendentals, to the bit, all five streams, on the first
    trajectory alone and on all of ``ys``."""
    for y in (ys[:1], ys):
        want = vf._vector_filter_plain(params, y, LIBM_FNS)
        for f, a, b in zip(FIELDS, vf._host_shim_run(params, y, kernel=kernel), want):
            assert bool(torch.isfinite(b).all()), f
            assert torch.equal(a, b), f"{f}: max |diff| {float((a - b).abs().max()):.3e}"


#: (system, Gauss-Hermite rule) of the classical shaped kernel (``VFS_GH``)
SHAPED_GH = [("pendulum", "sine", "gh3"), ("falling_body", "range", "gh2")]
#: (system, rule) of the general kernel's shaped form (``VGS_GH``)
GENERAL_GH = [("pendulum", "radar", "gh3"), ("pendulum", "ungm", "gh3"),
              ("pendulum", "b3", "gh3"), ("falling_body", "sine", "gh2"),
              ("falling_body", "b4", "gh2")]


@pytest.mark.parametrize("case", SHAPED_GH, ids="-".join)
def test_shaped_kernel_gh_counts_on_host_match_plain(hosts, case):
    """The classical shaped kernel at the Gauss-Hermite count of its pairs
    (9 points on the pendulum, 8 on the falling body) built with g++ == the
    plain version, to the bit."""
    params = _params(*case)
    assert params.dyn.n == params.obs.n == vf._gh_count(params.dim_state)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_shaped", 0)
    _held_to_plain(params, _simulate(*case[:2], seed=4), "vector_filter_shaped")


@pytest.mark.parametrize("case", GENERAL_GH, ids="-".join)
def test_general_shaped_form_gh_counts_on_host_match_plain(hosts, case):
    """The general kernel's shaped form at the Gauss-Hermite counts of
    ``VGS_GH`` built with g++ == the plain version, to the bit; each
    transform's point loops rolled or unrolled by its cost x 8 or 9."""
    params = _params(*case)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_general", vf._SHAPED)
    _held_to_plain(params, _simulate(*case[:2], seed=5), "vector_filter_general")


@pytest.mark.parametrize("rules", ["gh3", "ukf/ckf"])
def test_registered_shaped_form_gh_and_mixed_counts_on_host_match_plain(hosts, rules):
    """The registered driven pendulum with the table's radar under GH-3 (9
    points) and under the UKF beside the CKF (5 / 4 points): the registered
    kernel's shaped form, its policy stating both counts, built with g++ ==
    the plain version, to the bit."""
    params = _params("driven", None, rules)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_registered", vf._SHAPED)
    policy = vf._key(params)[3]
    assert f"ND = {params.dyn.n}, NO = {params.obs.n}" in policy
    d, o = _driven()
    gen = torch.Generator().manual_seed(6)
    ys = o.simulate_measurements(gen, d.simulate_discrete(gen, steps=20, mc_sims=4))
    _held_to_plain(params, ys.permute(2, 0, 1), "vector_filter_registered")


def test_pendulum_radar_gh3_matches_jax_f64(hosts):
    """The pendulum + radar under GH-3 (the general kernel's shaped form):
    the host build against the JAX package's float64 filter with the same
    rules on the same measurements, all five streams at 1e-10."""
    ys = _simulate("pendulum", "radar", seed=7)
    d, o = _system("pendulum", "radar", jax_side=True)
    gh = st.GaussHermiteKalman(d, o, deg=3)
    ref = jax.jit(lambda b: st.gaussian_filter_batch(d, o, gh.tf_dyn, gh.tf_obs, b))(
        jnp.asarray(ys.numpy()))
    params = _params("pendulum", "radar", "gh3")
    got = vf._host_shim_run(params, ys, kernel=vf.kernel_of(params))
    for f, g in zip(FIELDS, got):
        g = g.permute(2, 1, 0) if g.ndim == 3 else g.permute(3, 1, 2, 0)     # (B, ..., T)
        assert bool(torch.isfinite(g).all()), f
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(ref, f)), atol=1e-10,
                                   rtol=1e-10, err_msg=f)


#: (system, rules) -> (kernel, lanes) the wrapper picks
ROUTES = [
    (("pendulum", "sine", "gh2"), ("vector_filter_shaped", 0)),        # the CKF's 4 points
    (("pendulum", "sine", "gh3"), ("vector_filter_shaped", 0)),
    (("falling_body", "range", "gh2"), ("vector_filter_shaped", 0)),
    (("pendulum", "sine", "gh4"), ("vector_filter", 0)),               # 16 points
    (("pendulum", "sine", "gpq-gh3"), ("vector_filter", 0)),           # BQ at 9 points
    (("pendulum", "sine", "gh3/ukf"), ("vector_filter", 0)),           # mixed with the UT's
    (("pendulum", "radar", "gh3"), ("vector_filter_general", vf._SHAPED)),
    (("falling_body", "b4", "gh2"), ("vector_filter_general", vf._SHAPED)),
    (("pendulum", "radar", "gpq-gh3"), ("vector_filter_general", 0)),
    (("pendulum", "b2", "gh3"), ("vector_filter_general", 0)),         # a pair it does not hold
    (("pendulum", "radar", "gh4"), ("vector_filter_slots", 0)),         # 16: the slot kernel
    (("driven", None, "gh3"), ("vector_filter_registered", vf._SHAPED)),
    (("driven", None, "ukf/ckf"), ("vector_filter_registered", vf._SHAPED)),
    (("driven", None, "gpq-gh3"), ("vector_filter_registered", 0)),
    (("driven", None, "gh4"), ("vector_filter_registered", vf._SLOTS)),  # its slot form
]


@pytest.mark.parametrize("case,want", ROUTES, ids=["-".join(map(str, c)) for c, _ in ROUTES])
def test_routes_of_gauss_hermite_counts(case, want):
    """Both rules classical at the Gauss-Hermite count of at most 11 points
    go to the shaped kernel on its pairs, the general kernel's shaped form on
    the pairs of ``VGS_GH``, the registered kernel's shaped form for a
    registered model (which also takes the UKF beside the CKF); a BQ rule at
    that count, another count or a pair the form does not hold keeps its
    route; GH-4 (16 points) goes to the slot design (the slot kernel, the
    registered kernel's slot form)."""
    _need_gxx()
    assert (vf.kernel_of(_params(*case)), vf.lanes_of(_params(*case))) == want


def _gh_list(header, macro):
    """``(D, E, dynamics id, measurement id, N)`` of the entries of ``macro``
    (both counts equal) in the header ``header``."""
    listed = _listed(header, macro, 2)
    assert all(nd == no for *_, nd, no in listed)
    return {entry[:5] for entry in listed}


def test_the_routing_sees_the_headers_gh_instantiations():
    """The shaped kernel instantiates the Gauss-Hermite count of each of its
    pairs with a 2-D or 3-D state (``VFS_GH`` in ``VFS_SHAPES``), the general
    kernel's shaped form that of each pair of ``VGS_PAIRS`` with one
    (``VGS_GH``, the eighth source, which ``vgs_launch`` calls and
    ``SOURCES`` builds), at ``vfs_gh_count``'s counts; and the routing sends
    GH-2 and GH-3 to a shaped form exactly at those, over every table pair
    of up to 4 outputs."""
    _need_gxx()
    shaped = open(f"{vf._build.CSRC}/vector_filter_shaped.cuh").read()
    assert "VFS_PAIRS(VFS_MIXED_OF, F) VFS_GH(F)" in shaped
    assert "VGS_GH(VGS_LAUNCH_IF)" in open(
        f"{vf._build.CSRC}/vector_filter_general_shaped_gh.cu").read()
    assert "vector_filter_general_shaped_gh.cu" in vf.SOURCES
    want = {"vector_filter_shaped": _gh_list("vector_filter_shaped.cuh", "VFS_GH"),
            "vector_filter_general": _gh_list("vector_filter_general_shaped.cuh", "VGS_GH")}
    for kernel, header, pairs in (
            ("vector_filter_shaped", "vector_filter_shaped.cuh", "VFS_PAIRS"),
            ("vector_filter_general", "vector_filter_general_shaped.cuh", "VGS_PAIRS")):
        assert want[kernel] == {(*p, vf._gh_count(p[0])) for p in _listed(header, pairs)
                                if vf._gh_count(p[0])}
    assert [vf._gh_count(D) for D in (2, 3, 4, 5)] == [9, 8, 0, 0]
    taken = {k: set() for k in want}
    for dyn in ("reentry", "cv", "pendulum", "falling_body", "ct"):
        for obs in ("sine", "range", "ungm", "radar", "b2", "b3", "b4"):
            for rule in ("gh2", "gh3"):
                p = _params(dyn, obs, rule)
                if p.dyn.n in (2 * p.dim_state, 2 * p.dim_state + 1) or p.dyn.n > 11:
                    continue
                kernel, lanes = vf.kernel_of(p), vf.lanes_of(p)
                if (kernel, lanes) in (("vector_filter_shaped", 0),
                                       ("vector_filter_general", vf._SHAPED)):
                    taken[kernel].add((p.dim_state, p.dim_out, p.dyn_model, p.obs_model,
                                       p.dyn.n))
    assert taken == want
