"""Helpers of the tests that hold ``ssmtoybox_torch/experiments`` against the
JAX package's study scripts in ``experiments/``: run a JAX script's ``main``
up to its filter bank, and compare two banks object by object."""
import importlib
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: transform and model attributes compared between the packages, where both have them
TF_KEYS = ("unit_sp", "wm", "wc_diag", "Wc_dense", "Wc", "Wcc", "model_var", "unit_sp_eff",
           "alpha", "ell", "nu", "dim", "dim_out", "dim_eff")
MODEL_KEYS = ("dim_state", "dim_in", "dim_out", "dim_noise", "noise_additive", "noise_gain",
              "dt", "R0", "H0", "Gm0", "b0", "radar_loc", "state_index")
RV_KEYS = ("mean", "cov", "scale", "dof", "means", "covs", "alphas")


class Stop(Exception):
    """Raised by the recorder that stands in for a JAX script's filter bank."""


def run_jax_script(monkeypatch, name, argv, record_skl=False):
    """Run ``experiments/<name>.py``'s ``main`` with ``argv``: ``setup_jax``
    (platform pin, compile cache) and ``print_tables`` patched to no-ops, and
    ``run_filter_bank`` to a recorder that keeps ``(algs, y, x)`` and stops
    ``main``.  With ``record_skl`` the calls of the JAX package's
    ``symmetrized_kl_divergence`` are kept too (their arguments: the truth's
    and each transform's moments).  Returns the record (a dict)."""
    import ssmtoybox_tpu.utils as jutils

    mod = importlib.import_module(f"experiments.{name}")
    rec = {"skl": []}

    def record(algs, y, x, **kw):
        rec.update(algs=algs, y=np.asarray(y), x=np.asarray(x), kw=kw)
        raise Stop

    monkeypatch.setattr(mod, "setup_jax", lambda *a, **k: None)
    monkeypatch.setattr(mod, "print_tables", lambda *a, **k: None)
    monkeypatch.setattr(mod, "run_filter_bank", record, raising=False)
    if record_skl:
        skl = jutils.symmetrized_kl_divergence

        def kept(*args):
            rec["skl"].append(tuple(np.asarray(a) for a in args))
            return skl(*args)

        monkeypatch.setattr(jutils, "symmetrized_kl_divergence", kept)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    try:
        mod.main()
    except Stop:
        pass
    return rec


def arr(v):
    """An attribute of either package as a float64 NumPy array (None stays)."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().double().numpy()
    return np.asarray(v, dtype=np.float64)


def close(got, want, tol, what, floor=1e-300):
    """``got`` within ``tol`` of ``want``'s largest entry (or of ``floor``,
    if that is larger), shapes equal."""
    got, want = arr(got), arr(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), floor)
    err = float(np.abs(got - want).max(initial=0.0)) / scale
    assert err <= tol, f"{what}: {err:.3e} of the largest entry (limit {tol:.0e})"


def compare_attrs(port, jax_obj, keys, tol, what, shapes_only=False, floor=1e-300):
    """Every attribute of ``keys`` that both objects have and set."""
    seen = 0
    for k in keys:
        p, j = getattr(port, k, None), getattr(jax_obj, k, None)
        if k == "Wc" and getattr(jax_obj, "wc_diag", None) is not None:
            continue                           # the port's dense view of wc_diag
        if p is None or j is None or callable(p):
            continue
        seen += 1
        if shapes_only:
            assert arr(p).shape == arr(j).shape, (what, k)
        else:
            close(p, j, tol, f"{what}.{k}", floor)
    return seen


def same_class(port, jax_obj, what):
    """The port's class is the JAX object's, or a subclass of the port's
    class of that name (the JAX package builds its classical rules as plain
    ``SigmaPointTransform`` s)."""
    assert type(jax_obj).__name__ in [c.__name__ for c in type(port).__mro__], \
        (what, type(port), type(jax_obj))


def weight_tol(jtf, tol, key):
    """``tol``, or for a BQ rule on an ill-conditioned Gram matrix ``K`` the
    rounding of its solves, if that is larger: ``4 eps cond(K)``, and
    ``4 eps cond(K)^2`` for ``Wc = K^-1 Q K^-1``, which carries the inverse
    twice.  (The GPQ rule of the reentry study, length-scale 25 on the UT
    points, has ``cond(K) = 1.9e6``; the UNGM rules' are below 100.)  The
    model variance ``s^2 (1 - tr(Q K^-1))`` is a difference of terms of
    order one for these unit-scale Grams: :func:`compare_transform` holds it
    to ``max(|model_var|, 1)``."""
    iK = getattr(jtf, "iK", None)
    if iK is None:
        return tol
    cond = float(np.linalg.cond(np.asarray(iK)))
    return max(tol, 4 * np.finfo(np.float64).eps * cond ** (2 if key == "Wc" else 1))


def compare_transform(ptf, jtf, tol, what, shapes_only=False):
    same_class(ptf, jtf, what)
    seen = 0
    bq = getattr(jtf, "iK", None) is not None
    for k in TF_KEYS:
        seen += compare_attrs(ptf, jtf, (k,), weight_tol(jtf, tol, k), what, shapes_only,
                              floor=1.0 if bq and k == "model_var" else 1e-300)
    if hasattr(ptf, "points") and getattr(jtf, "model", None) is not None:
        close(ptf.points, jtf.model.points, tol, f"{what}.points")
        seen += 1
    assert seen, f"{what}: nothing compared"


def compare_model(pm, jm, tol, what):
    same_class(pm, jm, what)
    compare_attrs(pm, jm, MODEL_KEYS, tol, what)
    for rv in ("init_rv", "noise_rv"):
        p, j = getattr(pm, rv, None), getattr(jm, rv, None)
        if p is None and j is None:
            continue
        same_class(p, j, f"{what}.{rv}")
        assert compare_attrs(p, j, RV_KEYS, tol, f"{what}.{rv}")


def compare_banks(palgs, jalgs, tol=1e-12, mc_weights=()):
    """The same filters under the same names: each filter's class, models,
    noise RVs and transforms; the transforms of the filters in
    ``mc_weights`` (Monte-Carlo weights, drawn from other streams) by shape."""
    assert list(palgs) == list(jalgs)
    for name in jalgs:
        p, j = palgs[name], jalgs[name]
        p, j = getattr(p, "alg", p), getattr(j, "_alg", j)     # the square-root adapters
        same_class(p, j, name)
        compare_model(p.mod_dyn, j.mod_dyn, tol, f"{name}.mod_dyn")
        compare_model(p.mod_obs, j.mod_obs, tol, f"{name}.mod_obs")
        for tf in ("tf_dyn", "tf_obs"):
            compare_transform(getattr(p, tf), getattr(j, tf), tol, f"{name}.{tf}",
                              shapes_only=name in mc_weights)
        for k in ("dof", "fixed_dof", "newton_iters", "damping", "inner_dtype"):
            if hasattr(j, k):
                assert getattr(p, k) == getattr(j, k), (name, k)


def carry(jtf):
    """A JAX BQ transform's arrays as the port's transform
    (``convert.transform_from_numpy``)."""
    from ssmtoybox_torch import convert

    d = {"points": np.asarray(jtf.model.points), "wm": np.asarray(jtf.wm),
         "Wc": np.asarray(jtf.Wc), "Wcc": np.asarray(jtf.Wcc),
         "model_var": np.asarray(jtf.model_var), "integral_var": np.asarray(jtf.integral_var),
         "iK": np.asarray(jtf.iK)}
    if hasattr(jtf.model, "nu"):
        d["nu"] = jtf.model.nu
    return convert.transform_from_numpy(d, device="cpu")


#: tiny flags of each study, as the JAX script takes them
TINY = {
    "icinco_ungm": ["--steps", "15", "--mc", "6"],
    "bsq_ungm": ["--steps", "15", "--mc", "6"],
    "gpq_tracking": ["--dur", "2", "--mc", "4"],
    "bsq_tracking": ["--dur", "2", "--mc", "4"],
    "tpq_ungm": ["--steps", "15", "--mc", "6", "--tpq-samples", "4096"],
    "tpq_constant_velocity": ["--steps", "15", "--mc", "6", "--mc-weights", "4096"],
    "gpqd_demo": ["--steps", "15", "--mc", "6"],
    "marginal_ungm": ["--steps", "15", "--mc", "6"],
    "polar2cartesian_mt": ["--mc", "4096"],
}


def port_study(name, argv):
    """The port's study module ``name`` and its ``build`` from ``argv`` on
    the CPU."""
    mod = importlib.import_module(f"ssmtoybox_torch.experiments.{name}")
    return mod, mod.build(mod.parse([*argv, "--device", "cpu"]))


def both_harnesses(algs_port, algs_jax, rec):
    """The JAX script's data through the JAX harness and the port's, one
    call a filter: ``(port rows, JAX DataFrame)``."""
    from experiments import common as jcommon
    from ssmtoybox_torch.experiments import common

    jdf, _ = jcommon.run_filter_bank(algs_jax, rec["y"], rec["x"], verbose=False,
                                     warmup=False)
    prows, _ = common.run_filter_bank(algs_port, torch.as_tensor(rec["y"]),
                                      torch.as_tensor(rec["x"]), verbose=False, warmup=False)
    return prows, jdf


def scores_agree(prows, jdf, names, rtol=1e-8):
    """Every score and its spread within ``rtol``, ``diverged`` equal."""
    for name in names:
        jrow = jdf.loc[name]
        for col in ("rmse", "nci", "inc", "nll"):
            for k in (col, col + "_2std"):
                np.testing.assert_allclose(prows[name][k], float(jrow[k]), rtol=rtol,
                                           err_msg=f"{name} {k}")
        assert prows[name]["diverged"] == int(jrow["diverged"]), name
