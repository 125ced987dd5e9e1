"""The kernel of the BQ shapes at mixed point counts
(``csrc/vector_filter_shaped_bq_mixed.cu``, the step ``vfs_step_with<D, E,
ND, NO, KD, KO, ...>`` of ``csrc/vector_filter_shaped.cuh``): a BQ rule
(GPQ) at the UT count (2 D + 1 points) beside a rule at the CKF count (2 D)
or the other way round, on either transform or both, on the five model
pairs of ``VFS_PAIRS``.

- Host build (``vfs_bq_mixed_host_run`` of
  ``csrc/vector_filter_shaped_bq_host.cpp``, one g++ build a module) ==
  the plain version with the C library's transcendentals to the bit, all
  five streams, for every one of the 30 instantiations (5 pairs x 2 orders
  of the counts x 3 pairs of kinds), at ragged batches of 20-step records,
  the measurements read through their strides.
- Routing: :func:`vector_filter.kernel_of` sends each of the 30 to
  ``vector_filter_shaped_bq``, which the first version ran before; the
  header's instantiation list and the library's sources as the routing sees
  them; Gauss-Hermite rules below 243 points keep the first version.
- Against the JAX package on the CPU: reentry + radar under GPQ-UT or
  BSQ-UT on the dynamics beside the CKF on the measurement, the port's ``engine="dd"``
  (on the CPU the plain version of this kernel) at 4 x 20 against the JAX
  package's float64 ``gaussian_filter_batch`` with the same two
  transforms, at ``1e-9 x scale`` (scale: the largest filtered mean): every
  stream under BSQ-UT beside the CKF, and under GPQ-UT beside the CKF with
  the JAX package's GPQ weights in the port's step; with the port's own
  GPQ weights, which the two packages form differently, the filtered means
  and covariances.  (The JAX package's double-double engine,
  ``ops.ddvec.dd_filter_batch``, had not compiled this configuration after
  ten minutes on the CPU.)

Measurements come from a numpy seed (``_simulate`` of
``test_torch_vector_filter.py``) through the port's model functions.
"""
import re
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
import ssmtoybox_torch as stt
from ssmtoybox_torch import set_device
from ssmtoybox_torch.ops import vector_filter as vf

from test_torch_vector_filter import (BSQ_DYN, BSQ_OBS, GPQ_DYN, GPQ_OBS, GPQ_PEND, LIBM_FNS,
                                      MUL_UT, STREAMS, SYSTEMS, _simulate)


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


#: GPQ kernel parameters (dynamics, measurement) of each model pair: those of
#: ``tests/test_torch_vector_filter_bq.py`` and of ``chip_smoke.VF_GPQ_ZOO``
GPQ_PAR = {"reentry": (GPQ_DYN, GPQ_OBS), "cv": (np.array([[1.0, 3.0, 3.0, 3.0, 3.0]]),) * 2,
           "pendulum": (GPQ_PEND,) * 2, "falling_body": (np.array([[1.0, 3.0, 3.0, 3.0]]),) * 2,
           "ct_bearing": (np.array([[1.0, 3.0, 3.0, 3.0, 3.0, 3.0]]),) * 2}
#: the rules: GPQ on UT points (2 D + 1) and on spherical-radial points (2 D),
#: the UKF and the CKF
RULES = {"gpq_ut": lambda d, o, par: stt.GaussianProcessKalman(d, o, *par, points="ut"),
         "gpq_sr": lambda d, o, par: stt.GaussianProcessKalman(d, o, *par, points="sr"),
         "ukf": lambda d, o, par: stt.UnscentedKalman(d, o),
         "ckf": lambda d, o, par: stt.CubatureKalman(d, o)}
#: (dynamics rule, measurement rule) of the six instantiations of a model
#: pair: the UT count beside the CKF count, then the reverse, each with the
#: kinds (BQ, BQ), (classical, BQ), (BQ, classical)
ORDERS = [("gpq_ut", "gpq_sr"), ("ukf", "gpq_sr"), ("gpq_ut", "ckf"),
          ("gpq_sr", "gpq_ut"), ("ckf", "gpq_ut"), ("gpq_sr", "ukf")]
CASES = [(system, *order) for system in GPQ_PAR for order in ORDERS]
IDS = ["-".join(c) for c in CASES]


def _params(system, dyn_rule, obs_rule):
    dyn, obs = SYSTEMS[system][0]()
    a, b = (RULES[r](dyn, obs, GPQ_PAR[system]) for r in (dyn_rule, obs_rule))
    return vf.prepare(dyn, obs, a.tf_dyn, b.tf_obs)


@pytest.fixture(scope="module")
def host():
    """The g++ build of the mixed counts' host entry, once for the module."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the step header cannot be built for the host")
    return vf._shaped_bq_host()


@pytest.fixture(scope="module")
def data():
    return {s: _simulate(s, seed=4, batch=7) for s in GPQ_PAR}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mixed_bq_shapes_on_host_match_plain(host, data, case):
    """The host build of the case's instantiation == the plain version with
    the C library's transcendentals, to the bit, all five streams, on 1, 4 or
    7 trajectories (by the case's place in the list), time-major and
    trajectory-major."""
    system = case[0]
    params = _params(*case)
    D = params.dim_state
    assert {params.dyn.n, params.obs.n} == {2 * D + 1, 2 * D}
    assert 1 in (params.dyn.kind, params.obs.kind)
    batch = (1, 4, 7)[CASES.index(case) % 3]
    ys = data[system][:batch]
    want = vf._vector_filter_plain(params, ys, LIBM_FNS)
    for y in (ys, ys.permute(2, 1, 0).contiguous().permute(2, 1, 0)):
        got = vf._host_shim_run(params, y, kernel="vector_filter_shaped_bq")
        for s, a, b in zip(STREAMS, got, want):
            assert bool(torch.isfinite(b).all()), s
            assert torch.equal(a, b), f"{s}: {float((a - b).abs().max()):.3e}"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mixed_bq_shapes_route_to_the_bq_kernel(case):
    """Each of the 30 runs in ``vector_filter_shaped_bq`` (no general-kernel
    form), not in the first version."""
    params = _params(*case)
    assert vf.kernel_of(params) == "vector_filter_shaped_bq"
    assert vf.lanes_of(params) == 0


def test_the_routing_sees_the_headers_mixed_bq_instantiations():
    """The header lists the mixed counts of the BQ shapes on the five pairs
    (``VFS_BQ_MIXED``: both orders of the counts, three pairs of kinds), the
    seventh source launches them and is among the library's sources, the
    launcher of the BQ shapes sends mixed counts to it, and Gauss-Hermite
    rules of 16-242 points (the falling body's GH-3, 27 points; reentry's
    GH-2, 32) run in the slot kernel, the eleventh source."""
    src = vf._build.CSRC
    shaped = open(f"{src}/vector_filter_shaped.cuh").read()
    assert "#define VFS_BQ_MIXED(F) VFS_PAIRS(VFS_BQ_MIXED_OF, F)" in shaped
    assert re.search(r"VFS_BQ_MIXED_KINDS_OF\(F, D, E, DYN, OBS, 2 \* \(D\) \+ 1, 2 \* \(D\)\)"
                     r"\s+\\\s+VFS_BQ_MIXED_KINDS_OF\(F, D, E, DYN, OBS, 2 \* \(D\), "
                     r"2 \* \(D\) \+ 1\)", shaped)
    assert re.search(r"F\(D, E, DYN, OBS, ND, NO, 1, 1\) F\(D, E, DYN, OBS, ND, NO, 0, 1\) "
                     r"F\(D, E, DYN, OBS, ND, NO, 1, 0\)", shaped)
    assert "VFS_BQ_MIXED(VFS_BQ_MIXED_LAUNCH_IF)" in open(
        f"{src}/vector_filter_shaped_bq_mixed.cu").read()
    assert "return vfs_bq_launch_mixed(" in open(f"{src}/vector_filter_shaped_bq.cu").read()
    assert "vector_filter_shaped_bq_mixed.cu" in vf.SOURCES and len(vf.SOURCES) == 11
    for system, deg in (("falling_body", 3), ("reentry", 2)):
        dyn, obs = SYSTEMS[system][0]()
        gh = stt.GaussHermiteKalman(dyn, obs, deg=deg)
        assert vf.kernel_of(vf.prepare(dyn, obs, gh.tf_dyn, gh.tf_obs)) == "vector_filter_slots"


@pytest.mark.parametrize("rule", ["gpq_ut", "bsq_ut"])
def test_reentry_bq_ut_beside_ckf_matches_jax_f64(rule):
    """Reentry + radar under GPQ-UT or BSQ-UT on the dynamics beside the CKF
    on the measurement, 4 trajectories of 20 steps, against the JAX
    package's float64 ``gaussian_filter_batch`` with the same two
    transforms, at ``1e-9 x scale`` (scale: the largest filtered mean),
    the tolerance of ``tests/test_torch_vector_filter_bq.py`` against the
    same filter.  BSQ-UT: the port's ``engine="dd"`` (on the CPU the plain
    version of the kernel of the BQ shapes), all five streams.  GPQ-UT: the
    two packages form GPQ weights differently (the port ``wm wm^T + K^-1 (Q
    - q q^T) K^-1``, the JAX package ``K^-1 Q K^-1``), which parts the
    predicted covariances by up to 1.3e-3 (of 6.7) on these records; so the
    port's step on the JAX package's weights is held on all five streams,
    and ``engine="dd"`` on its own weights on the filtered means and
    covariances, as ``test_new_pairs_bq_fused_engine_matches_jax_f64``
    holds them."""
    import dataclasses
    ys = _simulate("reentry", seed=3, batch=4)
    dyn, obs = SYSTEMS["reentry"][0]()
    jdyn, jobs = SYSTEMS["reentry"][1]()
    if rule == "gpq_ut":
        tf = RULES["gpq_ut"](dyn, obs, GPQ_PAR["reentry"]).tf_dyn
        jtf = st.GaussianProcessKalman(jdyn, jobs, GPQ_DYN, GPQ_OBS, points="ut").tf_dyn
    else:
        tf = stt.BayesSardKalman(dyn, obs, BSQ_DYN, BSQ_OBS, MUL_UT, MUL_UT).tf_dyn
        jtf = st.BayesSardKalman(jdyn, jobs, BSQ_DYN, BSQ_OBS, mulind_dyn=MUL_UT,
                                 mulind_obs=MUL_UT, points="ut").tf_dyn
    alg = stt.GaussianInference(dyn, obs, tf, stt.CubatureKalman(dyn, obs).tf_obs)
    params = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
    assert vf.kernel_of(params) == "vector_filter_shaped_bq"
    ref = jax.jit(lambda b: st.gaussian_filter_batch(jdyn, jobs, jtf,
                                                     st.CubatureKalman(jdyn, jobs).tf_obs, b))(
        jnp.asarray(ys.numpy()))
    res = alg.forward_pass_batch(ys, engine="dd")
    on_jax = vf._vector_filter_plain(dataclasses.replace(params, dyn=dataclasses.replace(
        params.dyn, wm=np.asarray(jtf.wm), Wc=np.asarray(jtf.Wc), Wcc=np.asarray(jtf.Wcc),
        emv=float(np.asarray(jtf.model_var).reshape(())))), ys)
    scale = float(np.abs(np.asarray(ref.fi_mean)).max()) + 1.0
    for i, f in enumerate(("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")):
        want = np.asarray(getattr(ref, f))
        got, step = getattr(res, f).numpy(), on_jax[i]
        step = (step.permute(2, 1, 0) if step.ndim == 3 else step.permute(3, 1, 2, 0)).numpy()
        assert np.isfinite(got).all(), f
        if rule == "gpq_ut":
            np.testing.assert_allclose(step, want, rtol=0, atol=1e-9 * scale, err_msg=f)
        if rule == "bsq_ut" or f in ("fi_mean", "fi_cov"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * scale, err_msg=f)
