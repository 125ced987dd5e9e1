"""The kernel of the BQ shapes (``csrc/vector_filter_shaped_bq.cu``, the step
in ``csrc/vector_filter_shaped.cuh``): GPQ and BSQ rules at the UT and CKF
point counts in the fused vector filter, ``engine="dd"`` for 2-5-D states.

On the CPU:

- the step header built for the host with g++ (``vfs_bq_host_run``) equals
  the plain version ``_vector_filter_plain`` with the C library's
  transcendentals (``LIBM_FNS`` of ``test_torch_vector_filter.py``) to the
  bit, all five streams, at B = 1, 7 and 33, for GPQ-UT and BSQ-UT on
  reentry + radar, BSQ-UT on constant velocity + radar, GPQ with
  spherical-radial points on the pendulum, GPQ-UT on the falling body with
  its range and on the coordinated turn with four bearings (whose point
  loops stay loops), and the mixed kinds UKF / BSQ-UT and BSQ-UT / UKF;
- the port's fused engine on the new model pairs' BQ configurations against
  the JAX package's float64 ``gaussian_filter_batch`` at ``1e-9 x scale``,
  the tolerance of ``test_new_pairs_plain_matches_jax_f64``
  (``tests/test_ddvec.py:308-329``'s for its dd engine): the two sum the BQ
  quadratic form in different orders;
- the ctypes mirror of the parameter struct against the header, and the
  refusals: a rule the struct cannot hold raises before any build or call,
  two classical rules at mixed counts run no instantiation of the BQ shapes.

Measurements come from a numpy seed (``_simulate`` of
``test_torch_vector_filter.py``): 33 trajectories of 20 steps.
"""
import ctypes
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

from test_torch_vector_filter import (CONFIGS, GPQ_DYN, GPQ_OBS, GPQ_PEND, LIBM_FNS, STREAMS,
                                      SYSTEMS, _simulate)


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


#: GPQ kernel parameters of the falling body and of the coordinated turn:
#: length-scales short enough for a well-conditioned Gram matrix (at 10 the
#: two packages' Wc differ by ~1e-9 and their filtered means by ~1e-7 of scale)
GPQ_FALL = np.array([[1.0, 3.0, 3.0, 3.0]])
GPQ_CT = np.array([[1.0, 3.0, 3.0, 3.0, 3.0, 3.0]])
#: BSQ of the CV radar system (``chip_smoke.VF_CV_BSQ``) and its multi-index
BSQ_CV = np.array([[1.0, 100.0, 100.0, 100.0, 100.0]])
MUL_UT4 = np.hstack((np.zeros((4, 1), int), np.eye(4, dtype=int), 2 * np.eye(4, dtype=int)))
#: the most that a kernel's parameters may take from CUDA 12.1 on, in bytes
PARAM_LIMIT = 32764


def _gpq(par, points):
    return (lambda d, o: stt.GaussianProcessKalman(d, o, par, par, points=points),
            lambda d, o: st.GaussianProcessKalman(d, o, par, par, points=points))


#: name -> (system, port filter, JAX filter); "DYN/OBS": the dynamics rule of
#: one configuration and the measurement rule of the other
BQ_CONFIGS = {
    "gpq_ut": CONFIGS["gpq_ut"][:3],
    "bsq_ut": CONFIGS["bsq_ut"][:3],
    "cv_bsq_ut": ("cv", lambda d, o: stt.BayesSardKalman(d, o, BSQ_CV, BSQ_CV, MUL_UT4, MUL_UT4),
                  lambda d, o: st.BayesSardKalman(d, o, BSQ_CV, BSQ_CV, mulind_dyn=MUL_UT4,
                                                  mulind_obs=MUL_UT4, points="ut")),
    "pend_gpq_sr": ("pendulum", *_gpq(GPQ_PEND, "sr")),
    "fall_gpq_ut": ("falling_body", *_gpq(GPQ_FALL, "ut")),
    "ct_gpq_ut": ("ct_bearing", *_gpq(GPQ_CT, "ut")),
    "gpq_sr": ("reentry", lambda d, o: stt.GaussianProcessKalman(d, o, GPQ_DYN, GPQ_OBS,
                                                                 points="sr"),
               lambda d, o: st.GaussianProcessKalman(d, o, GPQ_DYN, GPQ_OBS, points="sr")),
    "ukf": CONFIGS["ukf"][:3],
    "ckf": CONFIGS["ckf"][:3],
}
#: the host-build cases: every model pair under a BQ rule, the mixed kinds
HOST_CASES = ["gpq_ut", "bsq_ut", "cv_bsq_ut", "pend_gpq_sr", "fall_gpq_ut", "ct_gpq_ut",
              "ukf/bsq_ut", "bsq_ut/ukf", "ckf/gpq_sr"]


def _params(name):
    """The kernel parameters of ``name`` (a "DYN/OBS" pair takes the
    measurement rule of OBS)."""
    a, _, b = name.partition("/")
    system, make, _ = BQ_CONFIGS[a]
    dyn, obs = SYSTEMS[system][0]()
    alg = make(dyn, obs)
    tf_obs = BQ_CONFIGS[b][1](dyn, obs).tf_obs if b else alg.tf_obs
    return system, vf.prepare(dyn, obs, alg.tf_dyn, tf_obs)


@pytest.fixture(scope="module")
def data33():
    return {s: _simulate(s, seed=2, batch=33) for s in
            ("reentry", "cv", "pendulum", "falling_body", "ct_bearing")}


@pytest.mark.parametrize("batch", [1, 7, 33])
@pytest.mark.parametrize("name", HOST_CASES)
def test_bq_shapes_on_host_match_plain(data33, name, batch):
    """``vfs_bq_host_run`` (the BQ shapes of ``vector_filter_shaped.cuh``,
    g++) == the plain version with the C library's transcendentals, to the
    bit, all five streams; measurements read through their strides."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the step header cannot be built for the host")
    system, params = _params(name)
    assert vf.kernel_of(params) == "vector_filter_shaped_bq"
    assert 1 in (params.dyn.kind, params.obs.kind)
    ys = data33[system][:batch]
    time_major = ys.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    want = vf._vector_filter_plain(params, ys, LIBM_FNS)
    for y in (ys, time_major):
        got = vf._host_shim_run(params, y, kernel="vector_filter_shaped_bq")
        for s, a, b in zip(STREAMS, got, want):
            assert bool(torch.isfinite(b).all()), s
            assert torch.equal(a, b), f"{s}: {float((a - b).abs().max()):.3e}"


@pytest.mark.parametrize("name", ["pend_gpq_sr", "fall_gpq_ut", "ct_gpq_ut"])
def test_new_pairs_bq_fused_engine_matches_jax_f64(data33, name):
    """``forward_pass_batch(engine="dd")`` (on the CPU, the plain version of
    the kernel ``kernel_of`` names) against the JAX package's float64
    filter, means and covariances at ``1e-9 x scale``: the tolerance of
    ``test_new_pairs_plain_matches_jax_f64``; the port's order of the BQ
    quadratic form is not XLA's."""
    system, make, make_jax = BQ_CONFIGS[name]
    ys = data33[system][:8]
    jdyn, jobs = SYSTEMS[system][1]()
    jalg = make_jax(jdyn, jobs)
    ref = jax.jit(lambda b: st.gaussian_filter_batch(jdyn, jobs, jalg.tf_dyn, jalg.tf_obs, b))(
        jnp.asarray(ys.numpy()))
    alg = make(*SYSTEMS[system][0]())
    assert vf.kernel_of(vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)) == (
        "vector_filter_shaped_bq")
    res = alg.forward_pass_batch(ys, engine="dd")
    scale = float(np.max(np.abs(np.asarray(ref.fi_mean)))) + 1.0
    for f in ("fi_mean", "fi_cov"):
        assert bool(torch.isfinite(getattr(res, f)).all()), f
        np.testing.assert_allclose(getattr(res, f).numpy(), np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-9 * scale, err_msg=f)


@pytest.mark.parametrize("name,kernel", [
    ("gpq_ut", "vector_filter_shaped_bq"), ("pend_gpq_sr", "vector_filter_shaped_bq"),
    ("ukf/bsq_ut", "vector_filter_shaped_bq"), ("ckf/gpq_sr", "vector_filter_shaped_bq"),
    ("gpq_sr/ckf", "vector_filter_shaped_bq"), ("ckf", "vector_filter_shaped"),
    ("ukf/ckf", "vector_filter_shaped"), ("bsq_ut/ckf", "vector_filter_shaped_bq")])
def test_kernel_of_sends_bq_rules_at_the_shaped_counts_to_the_bq_shapes(name, kernel):
    """GPQ and BSQ rules, alone or beside a classical rule, at the point
    counts N = 2 D + 1 or 2 D take the BQ shapes, one count on both rules or
    the two mixed; two classical rules the classical shaped kernel, at mixed
    counts too."""
    assert vf.kernel_of(_params(name)[1]) == kernel


def test_bq_parameter_struct_matches_the_header():
    """The ctypes mirror of ``VfsBqRule`` / ``VfsBqParams`` has the header's
    fields, in order, and its sizes (2,032 and 5,968 bytes), within the
    32,764 bytes that a kernel's parameters may take from CUDA 12.1 on (the
    launch's other arguments: 80 bytes)."""
    src = open(vf._build.CSRC + "/vector_filter_shaped.cuh").read()
    for struct, mirror in (("VfsBqRule", vf._CShapedBqRule), ("VfsBqParams", vf._CShapedBqParams)):
        body = src.split(f"struct {struct} {{")[1].split("};")[0]
        at = [body.index(f" {name}" + ("[" if issubclass(ctype, ctypes.Array) else ";"))
              for name, ctype in mirror._fields_]
        assert at == sorted(at), struct
    assert ctypes.sizeof(vf._CShapedBqRule) == 2032 and "2,032 bytes" in src
    assert ctypes.sizeof(vf._CShapedBqParams) == 5968 and "5,968 bytes" in src
    assert "sizeof(VfsBqRule) == 2032 && sizeof(VfsBqParams) == 5968" in src
    assert ctypes.sizeof(vf._CShapedBqParams) + 128 <= PARAM_LIMIT
    assert f"+ 128 <= {PARAM_LIMIT}" in src
    cu = open(vf._build.CSRC + "/vector_filter_shaped_bq.cu").read()
    assert "__grid_constant__ VfsBqParams" in cu
    assert "vector_filter_shaped_bq.cu" in vf.SOURCES


def test_bq_shapes_refuse_what_they_cannot_run(data33, monkeypatch):
    """A rule the struct cannot hold (Gauss-Hermite of degree 3, 243 points)
    is refused with a ``ValueError`` before anything is built or called;
    two classical rules at mixed counts (the classical kernel's shape) reach
    the host entry of the BQ shapes' mixed counts, which runs no
    instantiation."""
    dyn, obs = SYSTEMS["reentry"][0]()
    gh = CONFIGS["gh3"][1](dyn, obs)
    params = vf.prepare(dyn, obs, gh.tf_dyn, gh.tf_obs)

    def no_build():
        raise AssertionError("built a library for a rule the struct cannot hold")
    with monkeypatch.context() as m:
        m.setattr(vf, "_host_shim", no_build)
        m.setattr(vf, "build", no_build)
        with pytest.raises(ValueError, match="kernel of the BQ shapes takes classical and BQ "
                                             "rules of up to 11 points"):
            vf._host_shim_run(params, data33["reentry"][:1], kernel="vector_filter_shaped_bq")
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the step header cannot be built for the host")
    _, mixed = _params("ukf/ckf")
    with pytest.raises(RuntimeError, match="ran the D=0 step"):
        vf._host_shim_run(mixed, data33["reentry"][:1], kernel="vector_filter_shaped_bq")


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch(data33):
    _, params = _params("bsq_ut")
    ys = data33["reentry"][:4]
    before = (vf.LAUNCHES, vf.SHAPED_LAUNCHES, vf.BQ_SHAPED_LAUNCHES)
    for a, b in zip(vf.vector_filter(params, ys), vf._vector_filter_plain(params, ys)):
        assert torch.equal(a, b)
    assert (vf.LAUNCHES, vf.SHAPED_LAUNCHES, vf.BQ_SHAPED_LAUNCHES) == before
