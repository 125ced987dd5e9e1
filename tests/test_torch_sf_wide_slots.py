"""The slot design of the scalar filter kernel's general and registered forms
above 16 points: rules of 17-32 points at 20, 24 and 32 compile-time slots
(``SFS_WIDE_SHAPES``, ``csrc/scalar_filter_slots_wide.cu``; the registered
form instantiates them for the configurations it is built for), and the
one-thread forms above 32 points.

- Host builds: ``csrc/scalar_filter_host.cpp`` built with g++ (one lane a
  trajectory) equals the plain version ``_scalar_filter_plain`` to the bit,
  all five streams, with the C library's square root and sine, on 30-step
  records of 1 and 7 trajectories: every new slot count with every pair of
  rule kinds (Gauss-Hermite of 17-32 points; GPQ on those points, kernel
  parameters ``[[1, 1]]``, whose weights keep every run finite), with the
  UNGM, sine and range measurements; a registered transition at 20 and 32
  slots and a registered measurement at 24 (the registered form's generated
  library, built once for the module); GH-33, UNGM and registered, one
  thread a trajectory.
- Routing: :func:`scalar_filter.geometry` (the step header's
  ``sf_design_of``, through the host build) names each case's design, slot
  count and lanes; :func:`scalar_filter.slots` agrees with the header's
  ``sf_slots`` for every pair of kinds and 1-40 points; the parameter
  struct's ctypes mirror against the header.
- Against the JAX package's double-double dd filter
  (``ssmtoybox_tpu.ops.ddfilter.scalar_filter_batch``, ``lax.scan`` engine)
  on the CPU: UNGM under GH-17 and GH-20, the filtered means of 20-step
  records of 4 trajectories at 1e-10 over the first 10 steps and at 1e-8
  over all 20, the tolerances of ``tests/test_torch_sf_slots.py``.
- GPQ on 17, 20, 24 and 32 Gauss-Hermite points (``KPAR``, the UNGM
  studies' parameters): the Gram's condition number and the variance both
  packages' weights give a constant, against the same weights in 60-digit
  arithmetic (run the module as a script for the readings).

Records are simulated with a numpy seed through the port's model functions
(``tests/test_torch_sf_slots.py``).
"""
import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu.ops.ddfilter import scalar_filter_batch as jax_scalar_filter_batch
from ssmtoybox_tpu.ssmod import UNGMMeasurement as JUNGMMeasurement
from ssmtoybox_tpu.ssmod import UNGMTransition as JUNGMTransition
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import set_device
from ssmtoybox_torch.ops import scalar_filter as sf

from test_torch_sf_slots import (LIBM_FNS, T, _records, _registered,  # noqa: F401 (a fixture)
                                 _system, gpq_weight_readings)


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


#: GPQ kernel parameters for rules of 17-32 Gauss-Hermite points: a length-scale
#: of 1 keeps the weights' variance of the UNGM step positive (the studies'
#: ``[[1, 3]]`` loses most runs there, as section "GPQ" below reads)
KPAR_WIDE = np.array([[1.0, 1.0]])


def _rule(d, o, rule):
    """The filter of ``rule`` (``a/b``: rule a on the dynamics, b on the
    measurement): ``ghN`` Gauss-Hermite of N points, ``gpq_ghN`` GPQ on them
    (``KPAR_WIDE``)."""
    if "/" in rule:
        a, b = (_rule(d, o, r) for r in rule.split("/"))
        return SimpleNamespace(mod_dyn=d, mod_obs=o, tf_dyn=a.tf_dyn, tf_obs=b.tf_obs)
    deg = int(rule.rpartition("gh")[2])
    if rule.startswith("gh"):
        return stt.GaussHermiteKalman(d, o, deg=deg)
    return stt.GaussianProcessKalman(d, o, KPAR_WIDE, KPAR_WIDE, points="gh",
                                     point_hyp={"degree": deg})


#: (transition, measurement, rule) -> (design, slots, lanes) the launcher gives
#: it: every new slot count with every pair of kinds, registered models, and
#: the one-thread design above 32 points
CASES = {
    ("ungm", "ungm", "gh17"): ("slots", 20, 2),
    ("ungm", "ungm", "gh20"): ("slots", 20, 2),
    ("ungm", "sine", "gh24"): ("slots", 24, 2),
    ("ungm", "range", "gh32"): ("slots", 32, 2),
    ("ungm", "ungm", "gh32"): ("slots", 32, 2),
    ("ungm", "ungm", "gpq_gh17"): ("slots", 20, 4),
    ("ungm", "ungm", "gh20/gpq_gh17"): ("slots", 20, 4),
    ("ungm", "sine", "gpq_gh20/gh9"): ("slots", 20, 4),
    ("ungm", "ungm", "gpq_gh24"): ("slots", 24, 4),
    ("ungm", "range", "gh21/gpq_gh24"): ("slots", 24, 4),
    ("ungm", "ungm", "gpq_gh24/gh24"): ("slots", 24, 4),
    ("ungm", "ungm", "gpq_gh32"): ("slots", 32, 8),
    ("ungm", "sine", "gh25/gpq_gh32"): ("slots", 32, 8),
    ("ungm", "ungm", "gpq_gh30/gh32"): ("slots", 32, 8),
    ("growth", "ungm", "gh17"): ("slots", 20, 2),
    ("growth", "ungm", "gpq_gh32"): ("slots", 32, 8),
    ("ungm", "sat", "gh24"): ("slots", 24, 2),
    ("ungm", "ungm", "gh33"): ("one-thread", 0, 1),
    ("growth", "ungm", "gh33"): ("one-thread", 0, 1),
}
IDS = ["-".join(c).replace("/", "+") for c in CASES]


def _params(case):
    d, o = _system(*case[:2])
    alg = _rule(d, o, case[2])
    return sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)


@pytest.fixture(scope="module")
def host_built():
    """One g++ build of the registered form's generated source for the
    module's registered cases (the kernel's own models' host build is
    ``csrc/scalar_filter_host.cpp`` as it stands, built at first use)."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the step header cannot be built for the host")
    registered = [p for p in map(_params, CASES) if sf.form_of(p) == "registered"]
    return sf.build_registered(registered, host=True)


@pytest.mark.parametrize("batch", [1, 7])
@pytest.mark.parametrize("case", list(CASES), ids=IDS)
def test_wide_slots_on_host_match_plain(host_built, case, batch):
    """The host build of the case's design == the plain version to the bit,
    all five streams; measurements read through their strides (time-major
    and the transpose of a trajectory-major batch)."""
    params = _params(case)
    y = _records(case, batch, seed=7)
    c = sf.step_consts(params, T, "cpu")
    want = sf._scalar_filter_plain(params, y, c, sqrt=LIBM_FNS.sqrt, sin=LIBM_FNS.sin,
                                   fns=LIBM_FNS)
    for yy in (y, y.T.contiguous().T):
        for a, b in zip(sf._host_shim_run(params, yy, c), want):
            assert bool(torch.isfinite(b).all())
            assert torch.equal(a, b), f"max |diff| {float((a - b).abs().max()):.3e}"


@pytest.mark.parametrize("case", list(CASES), ids=IDS)
def test_geometry_routes_each_wide_case(host_built, case):
    """The form, design, slot count and lanes of each case, as the step
    header's ``sf_design_of`` gives them through the host build: 17-32
    points in the slot design at 20, 24 or 32 slots, classical rules on 2
    lanes, a BQ rule on 4 up to 24 slots and on 8 at 32; 33 points one thread a trajectory, with a
    scratch buffer of 33 values a trajectory (none in the slot design)."""
    params = _params(case)
    assert sf.form_of(params) == ("registered" if "growth" in case or "sat" in case
                                  else "general")
    assert sf.geometry(params) == CASES[case]
    n = max(params.dyn.n, params.obs.n)
    assert sf._scratch(params, 7, "cpu").numel() == (0 if CASES[case][1] else n * 7)


def test_slots_agrees_with_the_header_up_to_40_points(host_built):
    """:func:`scalar_filter.slots` gives the header's ``sf_slots`` (through
    ``sf_design``) for both kinds of either rule and 1-40 points: the
    smallest of :data:`scalar_filter.SLOTS` that holds both rules, 0 above
    32; 1, 2, 4 or 8 lanes in the slot design, 1 above it."""
    lib = sf._host_shim()
    got_slots, got_lanes = ctypes.c_int(), ctypes.c_int()
    assert sf.SLOTS[-4:] == (16, 20, 24, 32) and sf.MAX_SLOTS == 32
    for kd in (0, 1):
        for ko in (0, 1):
            for n_dyn in range(1, 41):
                for n_obs in (1, 17, n_dyn):
                    lib.sf_design(0, kd, ko, n_dyn, n_obs, ctypes.byref(got_slots),
                                  ctypes.byref(got_lanes))
                    p = SimpleNamespace(dyn=SimpleNamespace(kind=kd, n=n_dyn),
                                        obs=SimpleNamespace(kind=ko, n=n_obs))
                    assert got_slots.value == sf.slots(p), (kd, ko, n_dyn, n_obs)
                    n = max(n_dyn, n_obs)
                    assert got_slots.value == (0 if n > 32 else min(
                        s for s in sf.SLOTS if s >= n)), (kd, ko, n_dyn, n_obs)
                    assert got_lanes.value in ((1, 2, 4, 8) if got_slots.value else (1,))


def test_wide_slot_rules_struct_and_sources_match_the_header():
    """The ctypes mirror of ``SfsRules`` is the header's 2,048 bytes (both
    rules' four vectors of ``SF_MAX_SLOTS`` = 32), a rule's vectors are zero
    past its points and all zero above 32 points; the wide counts are the
    third source's, which the library builds; the slot design's kernel
    parameters are held under 4 KB by the header."""
    src = sf._build.CSRC
    general = open(f"{src}/scalar_filter_step_general.cuh").read()
    assert ctypes.sizeof(sf._CSlotRules) == 2048 and "sizeof(SfsRules) == 2048" in general
    assert "#define SFS_WIDE_COUNTS_OF(F, KD, KO) F(KD, KO, 20) F(KD, KO, 24) F(KD, KO, 32)" \
        in general
    step = open(f"{src}/scalar_filter_step.cuh").read()
    assert f"#define SF_MAX_SLOTS {sf.MAX_SLOTS}" in step and "#define SF_NARROW_SLOTS 16" in step
    assert "SFS_WIDE_SHAPES(SFS_LAUNCH_IF)" in open(f"{src}/scalar_filter_slots_wide.cu").read()
    assert "scalar_filter_slots_wide.cu" in sf.SOURCES
    assert "<= 4096" in open(f"{src}/scalar_filter_slots.cuh").read()
    params = _params(("ungm", "ungm", "gpq_gh24"))
    c = sf._c_slot_rules(params)
    assert list(c.dyn.xi) == list(params.dyn.xi) + [0.0] * 8
    assert list(c.obs.wcc) == list(params.obs.wcc) + [0.0] * 8
    assert not any(c.dyn.wc)
    assert not any(sf._c_slot_rules(_params(("ungm", "ungm", "gh33"))).dyn.xi)


@pytest.mark.parametrize("deg", [17, 20])
def test_wide_slots_match_jax_dd_filter(deg):
    """The port's ``engine="dd"`` (on the CPU, the plain version of the slot
    design's kernel at 20 slots) against the JAX package's double-double dd
    filter on the same 20-step records of 4 trajectories, UNGM under
    GH-``deg``: filtered means at 1e-10 over the first 10 steps, at 1e-8
    over all 20."""
    case = ("ungm", "ungm", f"gh{deg}")
    assert sf.geometry(_params(case))[:2] == ("slots", 20)
    ys = _records(case, 4)[:20].T.contiguous()                        # (B, N)
    jd = JUNGMTransition.create(JGaussRV.create(1, cov=5.0), JGaussRV.create(1, cov=10.0))
    jo = JUNGMMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1)
    jalg = st.GaussHermiteKalman(jd, jo, deg=deg)
    want = np.asarray(jax_scalar_filter_batch(jd, jo, jalg.tf_dyn, jalg.tf_obs,
                                              jnp.asarray(ys.numpy()), engine="scan"))
    d, o = _system(*case[:2])
    got = _rule(d, o, case[2]).forward_pass_batch(ys[:, None, :], engine="dd").fi_mean
    np.testing.assert_allclose(got.numpy()[..., :10], want[..., :10], atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=1e-8)


# ---------------------------------------------------------------------------
# GPQ on 17-32 Gauss-Hermite points: the weights of both packages against the
# same weights in 60-digit arithmetic
# ---------------------------------------------------------------------------

#: the Gauss-Hermite point counts of the readings: one rule at each new slot
#: count, and 17, the first past the old ceiling
GPQ_WIDE_DEGREES = (17, 20, 24, 32)


@pytest.mark.parametrize("deg", GPQ_WIDE_DEGREES)
def test_gpq_wide_weights_against_exact(deg):
    """GPQ on 17, 20, 24 and 32 Gauss-Hermite points (``KPAR``, the UNGM
    studies' ``[[1, 3]]``): the Gram's condition number is 8.1e8, 8.9e8,
    9.9e8 and 1.2e9.  The variance the weights give a constant (``1^T Wc 1 -
    (1^T wm)^2``; the exact weights' -2.0e-10 / 1.5e-10 / 1.9e-11 / 3.2e-11)
    is -1.4e-7 / -1.2e-7 / 1.6e-8 / -3.1e-9 in the port and -2.9e-6 /
    6.2e-6 / 2.9e-6 / -2.1e-6 in the JAX package: the port's is nearer the
    exact one at every count, by 21x and more (readings: ``python
    tests/test_torch_sf_wide_slots.py``)."""
    r = gpq_weight_readings(deg)
    assert r["cond"] > 5e8
    assert (abs(r["centred_port"] - r["centred_exact"])
            < abs(r["centred_jax"] - r["centred_exact"]) / 10), r


if __name__ == "__main__":
    # The GPQ readings of the test above and of ROADMAP.md's Queue 3:
    #     python tests/test_torch_sf_wide_slots.py
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401  (the suite's JAX settings: CPU, float64, its XLA flags)
    set_device("cpu")
    torch.set_num_threads(1)
    for deg in GPQ_WIDE_DEGREES:
        print(f"GPQ-GH{deg} weights:", {k: f"{v:.3e}" for k, v in gpq_weight_readings(deg).items()},
              flush=True)
