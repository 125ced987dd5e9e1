"""The slot form of the general and registered vector filter kernels
(``csrc/vector_filter_general_slots.cuh``): classical Gauss-Hermite rules of
16-81 points on both transforms of the general kernel's pairs of up to 4
outputs (``VSL_GENERAL`` of ``csrc/vector_filter_slots.cuh``, in the slot
kernel) and of a registered configuration (``VFR_SLOTS``, the registered
kernel's slot form), a trajectory on 1-4 lanes of a warp, the slot kernel's
step on their model policies.

- Host builds (g++ once a module, the lanes collapsed to one), to the bit
  against the plain version with the C library's transcendentals, all five
  streams, at ragged batches (1 and 4 trajectories, 20 steps): every shape
  of ``VSL_GENERAL`` (``vsg_host_run``, ``csrc/vector_filter_general_slots_host.cpp``)
  and the registered driven pendulum with the table's radar under GH-4
  (``vfr_slots_host_run``, the same source built for a registered library).
- Against the JAX package's float64 filter: CT + radar under GH-2 (32
  points), 4 x 20, all five streams at 1e-10, the tolerance of
  ``tests/test_torch_dd_mixed_counts.py``.
- Routing: ``kernel_of`` and ``lanes_of`` on the shapes that moved and on
  those that stay (GH-5 on a 2-D state, GPQ at a Gauss-Hermite count, GH-3
  on a 5-D state in the warp form); the header's lists (``VSL_GENERAL_LO``,
  ``VSL_GENERAL_HI``) as the routing sees them; the registered form's
  parameter struct's mirror.

Measurements come from a numpy seed (``tests/test_torch_dd_mixed_counts.py``'s
simulation through the port's model functions); the same arrays go to the
JAX package.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssmtoybox_tpu as st
import ssmtoybox_torch as stt
from ssmtoybox_torch import set_device
from ssmtoybox_torch.ops import forms, register_dyn_dd_vec
from ssmtoybox_torch.ops import vector_filter as vf

from test_torch_dd_gh_shaped import Driven2D, _driven, _driven_lower
from test_torch_dd_mixed_counts import (FIELDS, LIBM_FNS, _listed, _need_gxx, _simulate,
                                        _system)


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


#: rule name -> a filter of it on (dyn, obs)
RULES = {**{f"gh{d}": (lambda d: lambda dyn, obs: stt.GaussHermiteKalman(dyn, obs, deg=d))(d)
            for d in (2, 3, 4, 5)},
         "gpq-gh4": lambda dyn, obs: stt.GaussianProcessKalman(
             dyn, obs, np.array([[1.0] + [3.0] * dyn.dim_state]),
             np.array([[1.0] + [3.0] * dyn.dim_state]), points="gh", point_hyp={"degree": 4})}


def _params(dyn, obs, rule):
    """``vf.prepare`` of the table's system ``(dyn, obs)`` (names of
    ``tests/test_torch_dd_mixed_counts.py``) or of the driven pendulum with
    the radar (``"driven"``) under ``rule`` on both transforms."""
    d, o = _driven() if dyn == "driven" else _system(dyn, obs)
    alg = RULES[rule](d, o)
    return vf.prepare(d, o, alg.tf_dyn, alg.tf_obs)


#: the general kernel's pairs in the slot kernel, (system, rule): every
#: instantiation of ``VSL_GENERAL``
GENERAL_SLOTS = [("pendulum", "radar", "gh4"), ("pendulum", "ungm", "gh4"),
                 ("pendulum", "b3", "gh4"), ("falling_body", "sine", "gh3"),
                 ("falling_body", "b4", "gh3"), ("falling_body", "sine", "gh4"),
                 ("falling_body", "b4", "gh4"), ("cv", "b2", "gh2"), ("cv", "b3", "gh2"),
                 ("cv", "b2", "gh3"), ("cv", "b3", "gh3"), ("ct", "radar", "gh2"),
                 ("ct", "b2", "gh2"), ("ct", "b3", "gh2"), ("reentry", "range", "gh2"),
                 ("reentry", "ungm", "gh2")]


@pytest.fixture(scope="module")
def hosts():
    """The g++ builds: the general kernel's pairs in the slot kernel, and the
    registered driven pendulum + radar under GH-4 in the slot form."""
    _need_gxx()
    return vf._general_slots_host(), vf.build_registered([_params("driven", None, "gh4")], True)


def _held_to_plain(params, ys, kernel):
    """The host build of ``kernel`` against the plain version with the C
    library's transcendentals, to the bit, all five streams, on the first
    trajectory alone and on all of ``ys``."""
    for y in (ys[:1], ys):
        want = vf._vector_filter_plain(params, y, LIBM_FNS)
        for f, a, b in zip(FIELDS, vf._host_shim_run(params, y, kernel=kernel), want):
            assert bool(torch.isfinite(b).all()), f
            assert torch.equal(a, b), f"{f}: max |diff| {float((a - b).abs().max()):.3e}"


@pytest.mark.parametrize("case", GENERAL_SLOTS, ids="-".join)
def test_general_pairs_in_the_slot_kernel_on_host_match_plain(hosts, case):
    """Each general pair's shape of the slot kernel built with g++ == the
    plain version, to the bit, all five streams; its route the slot kernel,
    on the lanes the header names."""
    params = _params(*case)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_slots", 0)
    assert vf.slot_lanes(params) in (1, 2, 4, 8)
    _held_to_plain(params, _simulate(*case[:2], seed=11), "vector_filter_slots")


def test_registered_slot_form_on_host_matches_plain(hosts):
    """The driven pendulum (a registered transition with a per-step stream)
    with the table's radar under GH-4 (16 points), in the registered
    kernel's slot form built with g++, == the plain version to the bit, all
    five streams; its policy states N and the header's design for (2, 2,
    16)."""
    params = _params("driven", None, "gh4")
    assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_registered", vf._SLOTS)
    key = vf._key(params)
    assert key[:3] == (2, 2, vf._SLOTS)
    G, split, keep = vf._slot_design(params)
    assert G == vf.slot_lanes(params) > 0
    text = vf._registered_header([key])
    assert f"static constexpr int N = 16, G = {G};" in text
    assert f"split = {str(split).lower()}, keep = {str(keep).lower()};" in text
    assert "#define VFR_SLOTS(F) F(0, 2, 2, VfrPair0)" in text
    assert "#define VFR_SHAPED(F) \n" in text and "{ return {p.dyn_c, s}; }" in text
    d, o = _driven()
    x = d.simulate_discrete(torch.Generator().manual_seed(5), steps=20, mc_sims=4)
    ys = o.simulate_measurements(torch.Generator().manual_seed(6), x).permute(2, 0, 1)
    _held_to_plain(params, ys, "vector_filter_registered")


def test_ct_radar_gh2_matches_jax_f64(hosts):
    """CT + radar under GH-2 (32 points, a general pair now in the slot
    kernel): the host build against the JAX package's float64 filter with
    the same rules on the same measurements, all five streams at 1e-10."""
    ys = _simulate("ct", "radar", seed=12)
    d, o = _system("ct", "radar", jax_side=True)
    gh = st.GaussHermiteKalman(d, o, deg=2)
    ref = jax.jit(lambda b: st.gaussian_filter_batch(d, o, gh.tf_dyn, gh.tf_obs, b))(
        jnp.asarray(ys.numpy()))
    got = vf._host_shim_run(_params("ct", "radar", "gh2"), ys, kernel="vector_filter_slots")
    for f, g in zip(FIELDS, got):
        g = g.permute(2, 1, 0) if g.ndim == 3 else g.permute(3, 1, 2, 0)     # (B, ..., T)
        assert bool(torch.isfinite(g).all()), f
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(ref, f)), atol=1e-10,
                                   rtol=1e-10, err_msg=f)


#: (system, rule) -> (kernel, ``lanes_of``) of the shapes that moved and of
#: those that stay
ROUTES = [
    (("pendulum", "radar", "gh4"), ("vector_filter_slots", 0)),             # 16 points
    (("cv", "b3", "gh3"), ("vector_filter_slots", 0)),                      # 81
    (("ct", "radar", "gh2"), ("vector_filter_slots", 0)),                   # 32
    (("driven", None, "gh4"), ("vector_filter_registered", vf._SLOTS)),
    (("pendulum", "radar", "gh5"), ("vector_filter_general", 0)),           # 25: no slot shape
    (("driven", None, "gh5"), ("vector_filter_registered", 0)),
    (("pendulum", "radar", "gpq-gh4"), ("vector_filter_general", 0)),       # BQ at 16 points
    (("driven", None, "gpq-gh4"), ("vector_filter_registered", 0)),
    (("ct", "radar", "gh3"), ("vector_filter_general", vf._WARP)),          # 243 points
    (("reentry", "range", "gh3"), ("vector_filter_general", vf._WARP)),
]


@pytest.mark.parametrize("case,want", ROUTES, ids=["-".join(map(str, c)) for c, _ in ROUTES])
def test_routes_of_the_slot_forms(case, want):
    """Both rules classical at a Gauss-Hermite count of a general pair's slot
    shape go to the slot kernel, a registered configuration at such a count
    to the registered kernel's slot form; other degrees, a BQ rule at those
    counts and 243 points keep their routes (the one-thread form, the warp
    form)."""
    _need_gxx()
    assert (vf.kernel_of(_params(*case)), vf.lanes_of(_params(*case))) == want


def test_the_routing_sees_the_headers_general_slot_shapes():
    """The slot kernel's header lists the general pairs' shapes with their
    lanes (``VSL_GENERAL_LO`` and ``_HI``, built from two sources of
    ``SOURCES``), and the routing sends classical Gauss-Hermite rules of
    12-242 points on both transforms of the pairs of ``VGS_PAIRS`` to it
    exactly at those shapes, on those lanes, over GH-2 to GH-5; a registered
    configuration takes the lanes of the table's shape of its D and N."""
    _need_gxx()
    want = {e[:5]: e[5] for m in ("VSL_GENERAL_LO", "VSL_GENERAL_HI")
            for e in _listed("vector_filter_slots.cuh", m, 2)}
    assert len(want) == 16
    assert {"vector_filter_general_slots.cu", "vector_filter_general_slots_hi.cu"} <= set(
        vf.SOURCES)
    pairs = {e[:4] for e in _listed("vector_filter_general_shaped.cuh", "VGS_PAIRS")}
    taken = {}
    for system in {c[:2] for c in GENERAL_SLOTS}:
        for deg in (2, 3, 4, 5):
            p = _params(*system, f"gh{deg}")
            assert (p.dim_state, p.dim_out, p.dyn_model, p.obs_model) in pairs
            if not 11 < p.dyn.n < 243:
                continue
            if vf.kernel_of(p) == "vector_filter_slots":
                taken[p.dim_state, p.dim_out, p.dyn_model, p.obs_model, p.dyn.n] = vf.slot_lanes(p)
            else:
                assert vf.kernel_of(p) == "vector_filter_general" and vf.slot_lanes(p) == 0
    assert taken == want
    shapes = {**want, **{e[:5]: e[5] for e in _listed("vector_filter_slots.cuh", "VSL_SHAPES", 2)}}
    design = (ctypes.c_int * 3)()
    for D, E, N in ((2, 2, 16), (2, 4, 16), (3, 2, 27), (5, 3, 32), (4, 1, 81)):
        vf._fit().vsr_design_on(D, E, N, design)
        same = {abs(e[1] - E): g for e, g in shapes.items() if e[0] == D and e[4] == N}
        assert design[0] == same[min(same)]
    vf._fit().vsr_design_on(2, 2, 25, design)
    assert design[0] == 0


def test_registered_slot_parameters_mirror_the_header():
    """``_CSlotRegParams`` has the layout of ``VsrParams`` (11,488 bytes: the
    slot kernel's 10,976 and 32 constants of each form by value); the
    registered forms' constants stand in it."""
    assert ctypes.sizeof(vf._CSlotRegParams) == 11488
    params = _params("driven", None, "gh4")
    c = vf._c_registered_slots(params, torch.device("cpu"))
    assert list(c.dyn_c[:2]) == list(params.dyn_form.consts) and c.obs_c[0] == 0.0
    assert c.dyn.wm[15] == params.dyn.wm[15] and c.base.dim_state == 2
