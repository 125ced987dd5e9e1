"""Load transforms and models from NumPy arrays.

The bridge from the JAX package (or any other source) to the port: a caller
pulls a JAX object's arrays with ``np.asarray`` into a dict, and the port
builds the same object from them, on the device it names.  The port also
computes its own weights; the two agree to rounding.
"""
from __future__ import annotations

from .bq.transforms import BQTransform
from .mtran import SigmaPointTransform
from .ssmod import (Radar2DMeasurement, ReentryVehicle2DTransition, TransitionModel,
                    UNGMMeasurement, UNGMTransition)
from .utils.rv import GaussRV

__all__ = ["transform_from_numpy", "model_from_numpy"]

MODELS = {cls.__name__: cls for cls in (UNGMTransition, ReentryVehicle2DTransition,
                                         UNGMMeasurement, Radar2DMeasurement)}

#: optional constructor fields carried across per model class
_FIELDS = {"ReentryVehicle2DTransition": ("dt", "R0", "H0", "Gm0", "b0"),
           "Radar2DMeasurement": ("radar_loc",)}


def transform_from_numpy(d: dict, device=None):
    """A transform from its arrays.

    - sigma-point rule: ``unit_sp``, ``wm`` and ``wc_diag`` or ``Wc_dense``;
    - GP quadrature: ``points``, ``wm``, ``Wc``, ``Wcc``, ``model_var``,
      optionally ``iK`` and ``dim_out`` (default 1).
    """
    if "Wcc" in d:
        return BQTransform(d["points"], d["wm"], d["Wc"], d["Wcc"], d["model_var"],
                           dim_out=int(d.get("dim_out", 1)), iK=d.get("iK"), device=device)
    if "unit_sp" in d:
        return SigmaPointTransform(d["unit_sp"], d["wm"], wc_diag=d.get("wc_diag"),
                                   Wc_dense=d.get("Wc_dense"), device=device)
    raise ValueError(f"cannot tell the transform from the keys {sorted(d)}")


def model_from_numpy(kind: str, d: dict, device=None):
    """A model of class ``kind`` (e.g. ``"UNGMTransition"``) from its arrays.

    Transition models take ``init_mean``, ``init_cov``, ``noise_mean``,
    ``noise_cov`` and optionally ``noise_gain``; measurement models take
    ``noise_mean``, ``noise_cov``, ``dim_state`` and optionally
    ``state_index``.  Model fields such as ``dt`` or ``radar_loc`` are passed
    on where the class has them.
    """
    if kind not in MODELS:
        raise ValueError(f"unknown model {kind!r}; ported: {sorted(MODELS)}")
    cls = MODELS[kind]
    fields = {k: d[k] for k in _FIELDS.get(kind, ()) if k in d}
    noise_rv = GaussRV(cls.dim_noise, d["noise_mean"], d["noise_cov"], device=device)
    if issubclass(cls, TransitionModel):
        init_rv = GaussRV(cls.dim_state, d["init_mean"], d["init_cov"], device=device)
        return cls(init_rv, noise_rv, d.get("noise_gain"), **fields)
    return cls(noise_rv, int(d["dim_state"]), d.get("state_index"), **fields)
