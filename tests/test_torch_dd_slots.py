"""The slot kernel of the vector filter (``csrc/vector_filter_slots.cuh``):
Gauss-Hermite rules of 16-81 points on both transforms of the five model
pairs the first version instantiates, a trajectory on 2 or 4 lanes of a warp
(``ops.vector_filter.slot_lanes``), the shaped step with N a template
argument, the values gathered by shuffles.

- Host build (``csrc/vector_filter_slots_host.cpp``, ``vsl_host_run``, g++
  once a module; the lanes collapsed to one), to the bit against the plain
  version with the C library's transcendentals, all five streams, at ragged
  batches (1 and 4 trajectories, 20 steps): every shape of ``VSL_SHAPES``
  (reentry + radar and CT + 4 bearings under GH-2, CV + radar under GH-2
  and GH-3, the falling body + range under GH-3).
- Against the JAX package's float64 filter: reentry + radar under GH-2, 4 x
  20, all five streams at 1e-10, the tolerance of
  ``tests/test_torch_dd_mixed_counts.py``.
- Routing: ``kernel_of``, ``lanes_of`` and ``slot_lanes`` on the shapes the
  kernel takes and on those it leaves to the others; the header's list
  (``VSL_SHAPES``) as the routing sees it; the parameter struct's mirror.

Measurements come from a numpy seed (``tests/test_torch_dd_mixed_counts.py``'s
simulation through the port's model functions); the same arrays go to the
JAX package.
"""
import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
import ssmtoybox_torch as stt
from ssmtoybox_torch import set_device
from ssmtoybox_torch.ops import vector_filter as vf

from test_torch_dd_mixed_counts import (FIELDS, LIBM_FNS, _listed, _need_gxx, _simulate,
                                        _system)


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


#: rule name -> a filter of it on (dyn, obs)
RULES = {"ukf": stt.UnscentedKalman,
         **{f"gh{d}": (lambda d: lambda dyn, obs: stt.GaussHermiteKalman(dyn, obs, deg=d))(d)
            for d in (2, 3, 4, 5)},
         "gpq-gh2": lambda dyn, obs: stt.GaussianProcessKalman(
             dyn, obs, np.array([[1.0] + [3.0] * dyn.dim_state]),
             np.array([[1.0] + [3.0] * dyn.dim_state]), points="gh", point_hyp={"degree": 2})}


def _params(dyn, obs, rules):
    """``vf.prepare`` of the system under ``"DYN/OBS"`` rules (one name:
    both)."""
    d, o = _system(dyn, obs)
    a, _, b = rules.partition("/")
    return vf.prepare(d, o, RULES[a](d, o).tf_dyn, RULES[b or a](d, o).tf_obs)


@pytest.fixture(scope="module")
def host():
    """The slot kernel's step built with g++."""
    _need_gxx()
    return vf._slots_host()


#: (system, Gauss-Hermite rule) -> the lanes of its shape in ``VSL_SHAPES``
SLOT_SHAPES = {("reentry", "re_radar", "gh2"): 4, ("ct", "b4", "gh2"): 2,
               ("cv", "radar", "gh2"): 4, ("cv", "radar", "gh3"): 4,
               ("falling_body", "range", "gh3"): 4}


@pytest.mark.parametrize("case", list(SLOT_SHAPES), ids="-".join)
def test_slot_kernel_on_host_matches_plain(host, case):
    """Each shape of the slot kernel built with g++ == the plain version, to
    the bit, all five streams, on the first trajectory alone and on 4; the
    kernel's own route, on the lanes the header names."""
    params = _params(*case)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_slots", 0)
    assert vf.slot_lanes(params) == SLOT_SHAPES[case]
    ys = _simulate(*case[:2], seed=8)
    for y in (ys[:1], ys):
        want = vf._vector_filter_plain(params, y, LIBM_FNS)
        for f, a, b in zip(FIELDS, vf._host_shim_run(params, y, kernel="vector_filter_slots"),
                           want):
            assert bool(torch.isfinite(b).all()), f
            assert torch.equal(a, b), f"{f}: max |diff| {float((a - b).abs().max()):.3e}"


def test_reentry_gh2_matches_jax_f64(host):
    """Reentry + radar under GH-2 (32 points, the slot kernel's lane on
    ``chip_smoke.py``'s path): the host build against the JAX package's
    float64 filter with the same rules on the same measurements, all five
    streams at 1e-10."""
    ys = _simulate("reentry", "re_radar", seed=9)
    d, o = _system("reentry", "re_radar", jax_side=True)
    gh = st.GaussHermiteKalman(d, o, deg=2)
    ref = jax.jit(lambda b: st.gaussian_filter_batch(d, o, gh.tf_dyn, gh.tf_obs, b))(
        jnp.asarray(ys.numpy()))
    got = vf._host_shim_run(_params("reentry", "re_radar", "gh2"), ys,
                            kernel="vector_filter_slots")
    for f, g in zip(FIELDS, got):
        g = g.permute(2, 1, 0) if g.ndim == 3 else g.permute(3, 1, 2, 0)     # (B, ..., T)
        assert bool(torch.isfinite(g).all()), f
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(ref, f)), atol=1e-10,
                                   rtol=1e-10, err_msg=f)


#: (system, rules) -> (kernel, lanes of ``lanes_of``, ``slot_lanes``)
ROUTES = [
    (("reentry", "re_radar", "gh2"), ("vector_filter_slots", 0, 4)),
    (("cv", "radar", "gh3"), ("vector_filter_slots", 0, 4)),
    (("reentry", "re_radar", "gh3"), ("vector_filter_general", vf._WARP, 0)),   # 243 points
    (("ct", "b4", "gh3"), ("vector_filter_general", vf._WARP, 0)),
    (("pendulum", "sine", "gh4"), ("vector_filter", 0, 0)),                     # 16 points
    (("falling_body", "range", "gh4"), ("vector_filter", 0, 0)),                # 64
    (("cv", "radar", "gh4"), ("vector_filter_general", vf._WARP, 0)),           # 256 points
    (("reentry", "re_radar", "gpq-gh2"), ("vector_filter", 0, 0)),              # BQ at 32
    (("reentry", "re_radar", "gh2/ukf"), ("vector_filter", 0, 0)),              # mixed counts
    (("ct", "radar", "gh2"), ("vector_filter_slots", 0, 4)),                    # a general pair
]


@pytest.mark.parametrize("case,want", ROUTES, ids=["-".join(c) for c, _ in ROUTES])
def test_routes_of_slot_shapes(case, want):
    """Classical Gauss-Hermite rules on both transforms at a shape of
    ``VSL_SHAPES`` go to the slot kernel; other degrees, a BQ rule at those
    counts and mixed counts keep their routes (the first version, the warp
    form above 242 points); a general pair's Gauss-Hermite shape goes to the
    slot kernel too (``VSL_GENERAL``)."""
    _need_gxx()
    params = _params(*case)
    assert (vf.kernel_of(params), vf.lanes_of(params), vf.slot_lanes(params)) == want


def test_the_routing_sees_the_headers_slot_instantiations():
    """The slot kernel's header lists its shapes with their lanes
    (``VSL_SHAPES``), its source is the library's ninth, and the routing
    sends classical Gauss-Hermite rules of 12-242 points on both transforms
    to it exactly at those shapes, on those lanes, over the five pairs and
    GH-2 to GH-5."""
    _need_gxx()
    want = {entry[:5]: entry[5] for entry in _listed("vector_filter_slots.cuh", "VSL_SHAPES", 2)}
    assert len(want) == 5
    assert vf.SOURCES[-1] == "vector_filter_slots.cu"
    taken = {}
    for case in (("reentry", "re_radar"), ("cv", "radar"), ("pendulum", "sine"),
                 ("falling_body", "range"), ("ct", "b4")):
        for deg in (2, 3, 4, 5):
            p = _params(*case, f"gh{deg}")
            if not 11 < p.dyn.n < 243:
                continue
            if vf.kernel_of(p) == "vector_filter_slots":
                taken[p.dim_state, p.dim_out, p.dyn_model, p.obs_model, p.dyn.n] = vf.slot_lanes(p)
            else:
                assert vf.kernel_of(p) == "vector_filter" and vf.slot_lanes(p) == 0
    assert taken == want


def test_slot_parameters_mirror_the_header():
    """``_CSlotParams`` has the layout of ``VslParams`` (10,976 bytes: the
    first version's 1,904 and two rules of 81 points by value); a rule the
    struct cannot hold is refused before anything is built."""
    assert ctypes.sizeof(vf._CSlotRule) == 4536 and ctypes.sizeof(vf._CSlotParams) == 10976
    assert ctypes.sizeof(vf._CParams) == 1904
    params = _params("reentry", "re_radar", "gh3")                               # 243 points
    with pytest.raises(ValueError, match="up to 81 points"):
        vf._c_slot_params(params, torch.device("cpu"))
