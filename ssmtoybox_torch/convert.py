"""Load transforms, kernels and models from NumPy arrays.

The bridge from the JAX package (or any other source) to the port: a caller
pulls a JAX object's arrays with ``np.asarray`` into a dict, and the port
builds the same object from them, on the device it names.  The port also
computes its own weights; for closed-form rules the two agree to rounding,
for Monte-Carlo weights (``rbf-student``) carrying the JAX weights across is
what makes the two packages filter with the same numbers.
"""
from __future__ import annotations

import numpy as np

from . import ssmod
from .bq.gpqd import GaussianProcessDerTransform
from .bq.kernels import RBFStudent
from .bq.transforms import (BayesSardTransform, BQTransform, MultiOutputGaussianProcessTransform,
                            MultiOutputStudentTProcessTransform, StudentTProcessTransform)
from .mtran import (LinearizationTransform, MonteCarloTransform, SigmaPointTransform,
                    TaylorGPQDTransform, TruncatedSigmaPointTransform)
from .ssmod import TransitionModel
from .utils.rv import GaussianMixtureRV, GaussRV, StudentRV

__all__ = ["transform_from_numpy", "kernel_from_numpy", "rv_from_numpy", "model_from_numpy"]

MODELS = {name: getattr(ssmod, name) for name in ssmod.__all__
          if name not in ("TransitionModel", "MeasurementModel")}

#: optional constructor fields carried across per model class
_FIELDS = {"Pendulum2DTransition": ("dt", "g"),
           "ReentryVehicle1DTransition": ("dt", "Gamma"),
           "ReentryVehicle2DTransition": ("dt", "R0", "H0", "Gm0", "b0"),
           "CoordinatedTurnTransition": ("dt",),
           "ConstantTurnRateSpeed": ("dt", "compat_heading"),
           "ConstantVelocity": ("dt",),
           "RangeMeasurement": ("sx", "sy"),
           "BearingMeasurement": ("sensor_pos",),
           "Radar2DMeasurement": ("radar_loc",)}


def transform_from_numpy(d: dict, device=None):
    """A transform from its arrays.

    - sigma-point rule: ``unit_sp``, ``wm`` and ``wc_diag`` or ``Wc_dense``;
    - GP quadrature: ``points``, ``wm``, ``Wc``, ``Wcc``, ``model_var``,
      optionally ``iK``, ``integral_var`` and ``dim_out`` (default 1);
    - TP quadrature: the GP keys with ``iK``, plus ``nu`` (and optionally
      ``num_pts``, checked against the points);
    - BS quadrature: the GP keys plus ``mulind`` and optionally
      ``compat_kxpx_ell_squared`` (default True).  ``model_var`` may be a
      matrix (an override);
    - GPQ+D: the GP keys plus ``which_der``, the derivative points;
    - multi-output GP quadrature: ``points``, ``wm`` (N, E), ``Wc``
      (N, N, E, E), ``Wcc`` (D, N, E), ``Q`` (N, N, E, E), ``iK`` (N, N, E)
      and ``scale`` (E,), the kernel scales; multi-output TP quadrature adds
      ``nu`` (and optionally ``num_pts``, checked against the points);
    - truncated sigma-point rule: ``unit_sp_eff``, ``wm``, ``Wc``,
      ``unit_sp``, ``Wcc`` and ``dim_eff``;
    - Monte Carlo: ``unit_sp`` and the scalars ``wm``, ``wc``;
    - single-point GPQ+D (Taylor): ``alpha``, ``ell`` and ``dim``;
    - linearization: ``dim`` alone.

    The more specific key sets are tested first: a truncated or Monte-Carlo
    dict has ``unit_sp`` too.
    """
    if "Q" in d and "scale" in d:
        args = (d["points"], d["wm"], d["Wc"], d["Wcc"], d["Q"], d["iK"], d["scale"])
        if "nu" not in d:
            return MultiOutputGaussianProcessTransform.from_weights(*args, device=device)
        _check_num_pts(d)
        return MultiOutputStudentTProcessTransform.from_weights(*args, float(d["nu"]),
                                                                device=device)
    if "which_der" in d:
        return GaussianProcessDerTransform.from_weights(
            d["points"], d["wm"], d["Wc"], d["Wcc"], d["model_var"], d["which_der"],
            dim_out=int(d.get("dim_out", 1)), iK=d.get("iK"),
            integral_var=d.get("integral_var"), device=device)
    if "Wcc" in d and "dim_eff" in d:
        return TruncatedSigmaPointTransform(d["unit_sp_eff"], d["wm"], d["Wc"], d["unit_sp"],
                                            d["Wcc"], int(d["dim_eff"]), device=device)
    if "Wcc" in d:
        kw = dict(dim_out=int(d.get("dim_out", 1)), integral_var=d.get("integral_var"),
                  device=device)
        if "mulind" in d:
            return BayesSardTransform.from_weights(
                d["points"], d["wm"], d["Wc"], d["Wcc"], d["model_var"], d["mulind"],
                iK=d.get("iK"),
                compat_kxpx_ell_squared=bool(d.get("compat_kxpx_ell_squared", True)), **kw)
        if "nu" not in d:
            return BQTransform(d["points"], d["wm"], d["Wc"], d["Wcc"], d["model_var"],
                               iK=d.get("iK"), **kw)
        _check_num_pts(d)
        return StudentTProcessTransform.from_weights(d["points"], d["wm"], d["Wc"], d["Wcc"],
                                                     d["model_var"], d["iK"], float(d["nu"]),
                                                     **kw)
    if "unit_sp" in d and "wc" in d:
        return MonteCarloTransform(d["unit_sp"], float(d["wm"]), float(d["wc"]), device=device)
    if "unit_sp" in d:
        return SigmaPointTransform(d["unit_sp"], d["wm"], wc_diag=d.get("wc_diag"),
                                   Wc_dense=d.get("Wc_dense"), device=device)
    if "ell" in d:
        ker_par = np.concatenate([np.ravel(d["alpha"]), np.ravel(d["ell"])])[None]
        return TaylorGPQDTransform(int(d["dim"]), ker_par, device=device)
    if set(d) == {"dim"}:
        return LinearizationTransform(int(d["dim"]), device=device)
    raise ValueError(f"cannot tell the transform from the keys {sorted(d)}")


def _check_num_pts(d: dict):
    if "num_pts" in d and int(d["num_pts"]) != np.shape(d["points"])[-1]:
        raise ValueError(f"num_pts={int(d['num_pts'])} but {np.shape(d['points'])[-1]} points")


def kernel_from_numpy(d: dict, device=None) -> RBFStudent:
    """An :class:`RBFStudent` from the JAX kernel's settings: ``par``, ``dof``,
    ``num_samples``, ``num_batches``, ``seed`` and ``use_pallas`` (which
    becomes ``use_kernel``); ``dim`` defaults to the parameter width - 1."""
    par = d["par"]
    dim = int(d.get("dim", par.shape[-1] - 1))
    return RBFStudent(dim, par, dof=float(d.get("dof", 4.0)),
                      num_samples=int(d.get("num_samples", int(2e6))),
                      num_batches=int(d.get("num_batches", 50)), seed=int(d.get("seed", 0)),
                      use_kernel=d.get("use_pallas", True), device=device)


def rv_from_numpy(d: dict, device=None):
    """A random variable from its arrays: ``mean``, ``scale``, ``dof`` for a
    :class:`StudentRV`; ``means``, ``covs``, ``alphas`` for a
    :class:`GaussianMixtureRV`; else ``mean``, ``cov`` for a :class:`GaussRV`."""
    if "means" in d:
        means = np.asarray(d["means"])
        return GaussianMixtureRV(means.shape[-1], means, d["covs"], d["alphas"], device=device)
    dim = np.atleast_1d(d["mean"]).shape[-1]
    if "scale" in d:
        return StudentRV(dim, d["mean"], d["scale"], float(d["dof"]), device=device)
    return GaussRV(dim, d["mean"], d["cov"], device=device)


def model_from_numpy(kind: str, d: dict, device=None):
    """A model of class ``kind`` (e.g. ``"UNGMTransition"``) from its arrays.

    The RVs come as dicts for :func:`rv_from_numpy` under ``init_rv`` and
    ``noise_rv``, or as the Gaussian keys ``init_mean``, ``init_cov``,
    ``noise_mean``, ``noise_cov``.  Transition models take ``noise_gain``
    optionally; measurement models take ``dim_state`` and optionally
    ``state_index``.  Model fields such as ``dt`` or ``radar_loc`` are passed
    on where the class has them.
    """
    if kind not in MODELS:
        raise ValueError(f"unknown model {kind!r}; ported: {sorted(MODELS)}")
    cls = MODELS[kind]
    fields = {k: d[k] for k in _FIELDS.get(kind, ()) if k in d}

    def rv(name, dim):
        if f"{name}_rv" in d:
            return rv_from_numpy(d[f"{name}_rv"], device)
        return GaussRV(dim, d[f"{name}_mean"], d[f"{name}_cov"], device=device)

    noise_rv = rv("noise", cls.dim_noise)
    if issubclass(cls, TransitionModel):
        return cls(rv("init", cls.dim_state), noise_rv, d.get("noise_gain"), **fields)
    return cls(noise_rv, int(d["dim_state"]), d.get("state_index"), **fields)
