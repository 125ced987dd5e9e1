"""Fused whole-record Gaussian filter for states of dimension 2-8: CUDA kernel,
launcher, plain version.

Counterpart of the JAX package's ``ops/ddvec.py`` (``dd_filter_batch``, the
``engine="dd"`` path for D <= 8), which runs the filter step as a
``lax.scan`` of double-double f32-pair arithmetic in jnp because the TPU has
no f64 unit.  The card has native float64, so the port runs the whole record
of every trajectory inside one launch of a CUDA kernel in plain f64 and
returns all five moment streams that the RTS smoother reads.  Six kernels,
picked by the model pair and the rules' shape (:func:`kernel_of`):

- ``vector_filter_shaped`` (``csrc/vector_filter_shaped.cu``, the step in
  ``csrc/vector_filter_shaped.cuh``): both rules classical with N = 2 D + 1
  or 2 D points each (UKF, CKF: one count on both transforms, or the UKF
  beside the CKF either way round), or both at the Gauss-Hermite count of at
  most 11 points (GH-3 on the pendulum, GH-2 on the falling body), both
  counts template arguments, the rules by value;
- ``vector_filter_shaped_bq`` (``csrc/vector_filter_shaped_bq.cu`` and
  ``csrc/vector_filter_shaped_bq_mixed.cu``, the same step header): those
  counts with a BQ rule (GPQ, BSQ) on either transform or both, one count on
  both transforms or the UT count beside the CKF count either way round,
  both counts and both kinds template arguments, the rules (dense ``Wc``
  included) by value;
- ``vector_filter_slots`` (``csrc/vector_filter_slots.cu``, the step in
  ``csrc/vector_filter_slots.cuh``): classical Gauss-Hermite rules of 16-81
  points on both transforms (reentry + radar and CT + 4 bearings under GH-2,
  CV + radar under GH-2 and GH-3, the falling body under GH-3; and the
  general kernel's pairs of up to 4 outputs under GH-2 to GH-4 of 16-81
  points, ``csrc/vector_filter_general_slots.cu`` and ``_hi.cu`` on the
  general step's model policies), the shaped step with N a template
  argument and a trajectory's points split over 1-4 lanes of a warp
  (:func:`slot_lanes`), the values gathered by shuffles;
- ``vector_filter`` (``csrc/vector_filter.cu``, the step in
  ``csrc/vector_filter_step.cuh``), the first version: every other
  configuration of those pairs (rules of fewer than
  :data:`_WARP_MIN_POINTS` points at other counts: other Gauss-Hermite
  degrees, a BQ rule at a Gauss-Hermite count), one thread a trajectory, N at
  run time;
- ``vector_filter_general`` (``csrc/vector_filter_general.cu``, the steps in
  ``csrc/vector_filter_general.cuh`` and ``csrc/vector_filter_lanes.cuh``;
  ``csrc/vector_filter_general_shaped.cu`` and
  ``csrc/vector_filter_general_shaped_mixed.cu``, the step in
  ``csrc/vector_filter_general_shaped.cuh``): every other pair of the
  table's models; up to 4 measurement outputs one thread a trajectory, in
  the shaped form where both rules are classical at the UT or CKF count
  each or at the Gauss-Hermite count of at most 11 points on both, on a pair
  it instantiates (D, E, both counts, the models and the kinds template
  arguments, the rules by value, no scratch), else in the
  general one-thread form (the models, E, the kinds and N at run time; D
  and a bound on E template arguments); above 4 outputs the lane-group form (a trajectory on
  8 lanes of a warp, its arrays in shared memory; D a template argument);
  rules of many points (Gauss-Hermite, of those five pairs too) in the warp
  form (a trajectory on a whole warp, each lane a 32nd of the points),
  :func:`lanes_of`;
- ``vector_filter_registered`` (``csrc/vector_filter_registered.cu``): the
  general kernel's forms instantiated on models registered at run time
  (:func:`register_dyn_dd_vec`, :func:`register_obs_dd_vec`, and 1-D
  measurement forms of ``scalar_filter.register_obs_dd``), the shaped
  one-thread form at one UT or CKF count on both rules, of either kind, at
  the two mixed or at the Gauss-Hermite count of at most 11 points on both
  classical rules, the slot form (the slot kernel's step on the registered
  policy) at a Gauss-Hermite count of 16-81 points on both classical rules,
  the lane-group form also for states of more than 5 dimensions, built at first
  use from a header generated from their :class:`~.forms.KernelForm` s
  (:func:`build_registered`).

The first five take the table's models; the first four only the five
pairs ``ReentryVehicle2DTransition`` or ``ConstantVelocity`` with
``Radar2DMeasurement``, ``Pendulum2DTransition`` with
``Pendulum2DMeasurement``, ``ReentryVehicle1DTransition`` with
``RangeMeasurement`` and ``CoordinatedTurnTransition`` with a
``BearingMeasurement`` of four sensors.

Supported, as ``ddvec.dd_check`` admits them under the same registrations:
``2 <= dim_state <= 8``, additive noise on both models, any transition with
a kernel form (the table's five, or a registered one) with any measurement
with a kernel form (the radar, the sine, the range, bearings from any number
of sensors, ``UNGMMeasurement`` of a state component, or a registered one),
any ``state_index`` that picks the components a table's measurement reads,
and for each transform either a classical sigma-point rule with diagonal
covariance weights or a BQ rule with a scalar model variance.  A model's
form is looked up as the JAX package looks its evaluator up
(:func:`~.forms.find_dyn`, :func:`~.forms.find_obs`).  :func:`check` raises
``ValueError`` with the reason a configuration is refused; :func:`supports`
answers with a bool.

:func:`vector_filter` is the launch wrapper.  For a CPU tensor it runs the
plain PyTorch version :func:`_vector_filter_plain` (a registered form's
``plain``); for a CUDA tensor it launches the kernel of :func:`kernel_of` or
raises (a registered configuration whose library does not build raises with
the compiler's output).  Each launch adds one to :data:`LAUNCHES`; a launch
of the classical shaped kernel also to :data:`SHAPED_LAUNCHES`, one of the
kernel of the BQ shapes to :data:`BQ_SHAPED_LAUNCHES`, one of the slot
kernel to :data:`SLOT_LAUNCHES`, one of the general
kernel to :data:`GENERAL_LAUNCHES`, one of the registered kernel to
:data:`REGISTERED_LAUNCHES`; a launch of either in the lane-group form also
to :data:`GENERAL_LANE_LAUNCHES` or :data:`REGISTERED_LANE_LAUNCHES`, one
in the warp form to :data:`GENERAL_WARP_LAUNCHES` or
:data:`REGISTERED_WARP_LAUNCHES`, one in the shaped one-thread form to
:data:`GENERAL_SHAPED_LAUNCHES` or :data:`REGISTERED_SHAPED_LAUNCHES`, and
one of the registered kernel in its slot form to
:data:`REGISTERED_SLOT_LAUNCHES`.

As in :mod:`.scalar_filter`, nothing is lowered or copied per call that was
lowered before: a transform's :class:`VecRule` and a model's constants are kept
on the object they were read from (through ``scalar_filter._memo``, which
notices in-place edits), a rule's constants are copied to a card once, and
the parameter struct is cached by :class:`VectorFilterParams`.  A model's
form is looked up again at every :func:`prepare`, so a registration made
since takes effect.
"""
from __future__ import annotations

import ctypes
import functools
import re
from dataclasses import dataclass, field

import numpy as np
import torch

from ..bq.gpqd import GaussianProcessDerTransform
from ..bq.transforms import BQTransform, MultiOutputBQTransform, StudentTProcessTransform
from ..mtran import SigmaPointTransform
from ..ssmod import (BearingMeasurement, ConstantVelocity, CoordinatedTurnTransition,
                     Pendulum2DMeasurement, Pendulum2DTransition, Radar2DMeasurement,
                     RangeMeasurement, ReentryVehicle1DTransition, ReentryVehicle2DTransition,
                     UNGMMeasurement)
from . import _build, forms
from .forms import TORCH_FNS, KernelForm, Registered, find_dyn, find_obs
from .scalar_filter import _floats, _memo

__all__ = ["LAUNCHES", "SHAPED_LAUNCHES", "BQ_SHAPED_LAUNCHES", "SLOT_LAUNCHES",
           "GENERAL_LAUNCHES", "REGISTERED_LAUNCHES", "GENERAL_LANE_LAUNCHES",
           "REGISTERED_LANE_LAUNCHES", "GENERAL_WARP_LAUNCHES", "REGISTERED_WARP_LAUNCHES",
           "GENERAL_SHAPED_LAUNCHES", "REGISTERED_SHAPED_LAUNCHES", "REGISTERED_SLOT_LAUNCHES",
           "VecRule",
           "VectorFilterParams", "register_dyn_dd_vec", "register_obs_dd_vec", "lower_transform",
           "check", "supports", "prepare", "kernel_of", "lanes_of", "slot_lanes", "vector_filter",
           "build", "build_registered", "chain_floor_clocks", "TORCH_FNS"]

#: kernel launches made by :func:`vector_filter` in this process, all six kernels
LAUNCHES = 0
#: the launches of the classical shaped kernel among them
SHAPED_LAUNCHES = 0
#: the launches of the kernel of the BQ shapes among them
BQ_SHAPED_LAUNCHES = 0
#: the launches of the slot kernel among them
SLOT_LAUNCHES = 0
#: the launches of the general kernel among them
GENERAL_LAUNCHES = 0
#: the launches of the registered kernel among them
REGISTERED_LAUNCHES = 0
#: the general kernel's launches in the lane-group form, among its launches
GENERAL_LANE_LAUNCHES = 0
#: the registered kernel's launches in the lane-group form, among its launches
REGISTERED_LANE_LAUNCHES = 0
#: the general kernel's launches in the warp form, among its launches
GENERAL_WARP_LAUNCHES = 0
#: the registered kernel's launches in the warp form, among its launches
REGISTERED_WARP_LAUNCHES = 0
#: the general kernel's launches in the shaped one-thread form, among its launches
GENERAL_SHAPED_LAUNCHES = 0
#: the registered kernel's launches in the shaped one-thread form, among its launches
REGISTERED_SHAPED_LAUNCHES = 0
#: the registered kernel's launches in the slot form, among its launches
REGISTERED_SLOT_LAUNCHES = 0

#: largest state dimension the fused vector filter takes (``ddvec.DIM_MAX``):
#: ``VF_MAX_DIM`` of the step header, the size of the parameter struct's matrices
_MAX_DIM = 8
#: ``VFS_MAX_DIM`` and ``VFS_MAX_PTS`` of the shaped kernel's header: the
#: largest state of a model pair with a kernel form and its UT point count
_SHAPED_MAX_DIM, _SHAPED_MAX_PTS = 5, 11
#: ``VSL_MAX_DIM`` and ``VSL_MAX_PTS`` of the slot kernel's header: the
#: largest state and point count its parameters hold (GH-3 on a 4-D state)
_SLOT_MAX_DIM, _SLOT_MAX_PTS = 5, 81

#: no multiply-add contraction, as the scalar filter kernel is built: every
#: operation rounds on its own, like the plain version's separate operations
_NVCC_FLAGS = ["--fmad=false"]

#: the table's models, the kernels' own: class -> (id in the step header,
#: constants); a measurement's constants are a tensor on its device or a
#: tuple of floats.  ``UNGMMeasurement`` is found by exact type, as the JAX
#: package's scalar registry holds it (:func:`~.forms.find_obs`)
_DYN_MODELS = {
    ReentryVehicle2DTransition: (0, lambda m: (m.dt, m.R0, m.H0, m.Gm0, m.b0)),
    ConstantVelocity: (1, lambda m: (m.dt,)),
    Pendulum2DTransition: (2, lambda m: (m.dt, m.g * m.dt)),
    ReentryVehicle1DTransition: (3, lambda m: (m.dt, -m.Gamma)),
    CoordinatedTurnTransition: (4, lambda m: (m.dt,)),
}
_OBS_MODELS = {
    Radar2DMeasurement: (0, lambda m: m.radar_loc),
    Pendulum2DMeasurement: (1, lambda m: ()),
    RangeMeasurement: (2, lambda m: (m.sx ** 2, m.sy)),
    BearingMeasurement: (3, lambda m: m.sensor_pos),
    UNGMMeasurement: (4, lambda m: ()),
}
#: the pairs of model ids that the first version and the shaped kernels
#: instantiate: ``VF_MODELS`` of the step header; every other pair runs in the
#: general kernel
_PAIRS = {(0, 0), (1, 0), (2, 1), (3, 2), (4, 3)}
#: the bearing sensors of their bearing measurement
_BEARING_SENSORS = 4
#: ``VF_MAX_OBS_C``: room for the measurement's constants in the parameter
#: struct (8 sensors' x, y); the general kernels read them from device memory
_MAX_OBS_C = 16
#: the lanes a trajectory of the lane-group form runs on (``VFL_G`` of
#: ``csrc/vector_filter_lanes.cuh``, what its launchers take beside 0)
_LANES = 8
#: the fewest warps of the lane-group form an SM must hold for that form to
#: take a shape of at most 8 outputs from the one-thread form (PERF.md, PR
#: 21: it won at 10-20 warps, lost at 1-2, many-point rules); and of the warp
#: form for it to take a shape
_MIN_LANE_WARPS = 4
#: the lanes a trajectory of the warp form runs on (``VFL_WARP`` of
#: ``csrc/vector_filter_lanes.cuh``)
_WARP = 32
#: the fewest points of both rules for which the warp form takes a shape
#: (:func:`lanes_of`, which gives the evidence)
_WARP_MIN_POINTS = 243
#: what :func:`lanes_of` answers for the shaped one-thread form of the general
#: and registered kernels (``csrc/vector_filter_general_shaped.cuh``): one lane
#: a trajectory, the shape known when compiling
_SHAPED = 1
#: what :func:`lanes_of` answers for the registered kernel's slot form
#: (``csrc/vector_filter_general_slots.cuh``): its lanes a trajectory are the
#: design's (:func:`slot_lanes`)
_SLOTS = -1
#: ``VGS_MAX_C``: a registered form's constants the shaped and slot forms'
#: parameters hold by value
_VGS_MAX_C = 32


def register_dyn_dd_vec(model_cls, lower):
    """Register a transition model for ``engine="dd"`` (``ddvec.
    register_dyn_dd_vec``): ``lower(model, n_steps) -> (streams, form)``,
    ``streams`` a list of (n_steps,) float64 arrays of per-step constants
    (step k reads value k of each), ``form`` the transition's
    :class:`~.forms.KernelForm`.  Found through the MRO, a class's own
    registration before its bases'; registering a class again replaces its
    entry.  2-8-D states run in the registered vector kernel, 1-D ones in the
    scalar filter kernel's registered form."""
    forms.DYN_DD_VEC[model_cls] = lower


def register_obs_dd_vec(model_cls, lower):
    """Register a measurement model (``ddvec.register_obs_dd_vec``):
    ``lower(model) -> form``, a :class:`~.forms.KernelForm` that reads the
    whole state and gathers the components it measures itself.  Found
    through the MRO."""
    forms.OBS_DD_VEC[model_cls] = lower


# ---------------------------------------------------------------------------
# lowering a configuration to kernel constants
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class VecRule:
    """A quadrature rule of ``dim_in`` inputs as kernel constants.  ``kind``
    0: classical (``wc`` diagonal covariance weights); 1: BQ (dense ``Wc``
    (n, n), cross weights ``Wcc`` (dim_in, n), expected model variance
    ``emv``).  ``xi`` (dim_in, n) are the unit points.  Compared and hashed
    by identity: a transform keeps its rule."""

    kind: int
    xi: np.ndarray
    wm: np.ndarray
    wc: np.ndarray | None = None
    Wc: np.ndarray | None = None
    Wcc: np.ndarray | None = None
    emv: float = 0.0
    _on: dict = field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return self.xi.shape[1]

    def packed(self, device: torch.device) -> torch.Tensor:
        """The constants as one float64 tensor on ``device``, ``xi | wm | wc``
        or ``xi | wm | Wc | Wcc`` (row-major), copied there once."""
        t = self._on.get(device)
        if t is None:
            parts = [self.xi, self.wm] + ([self.wc] if self.kind == 0 else [self.Wc, self.Wcc])
            t = torch.as_tensor(np.concatenate([np.ravel(a) for a in parts]), device=device)
            self._on[device] = t
        return t


def lower_transform(tf, dim_in: int) -> VecRule:
    """The kernel's constants for a transform of ``dim_in`` inputs;
    ``ValueError`` with the reasons of ``ddvec._lower_transform_vec`` if the
    kernel cannot run it.  The weights are read from the transform's device
    once and kept on the transform."""
    if isinstance(tf, SigmaPointTransform):
        sources = (tf.unit_sp, tf.wm, tf.wc_diag)
    elif isinstance(tf, BQTransform):
        sources = (tf.points, tf.wm, tf.Wc, tf.Wcc, tf.model_var)
    elif isinstance(tf, MultiOutputBQTransform):
        sources = (tf.points, tf.wm)
    else:
        raise ValueError(f"unsupported transform for the fused vector filter: {type(tf)!r}")
    return _memo(tf, f"_vector_filter_rule_{dim_in}", sources, lambda: _lower(tf, dim_in))


def _host(t) -> np.ndarray:
    return np.asarray(t.detach().cpu(), np.float64)


def _lower(tf, dim_in: int) -> VecRule:
    if isinstance(tf, SigmaPointTransform):
        if tf.wc_diag is None:
            raise ValueError("the fused vector filter needs diagonal classical weights "
                             "(wc_diag); dense-Wc classical rules are not supported")
        xi = _host(tf.unit_sp)
        if xi.shape[0] != dim_in:
            raise ValueError(f"transform dimension {xi.shape[0]} != expected {dim_in} "
                             "(non-additive augmentation is not supported)")
        return VecRule(kind=0, xi=xi, wm=_host(tf.wm), wc=_host(tf.wc_diag))
    if isinstance(tf, StudentTProcessTransform):
        raise ValueError("the fused vector filter has no data-dependent (TPQ) model variance")
    if isinstance(tf, GaussianProcessDerTransform):
        raise ValueError("GPQ+D derivative observations have no kernel form in the fused "
                         "vector filter")
    if isinstance(tf, MultiOutputBQTransform):
        raise ValueError(f"multi-output BQ transforms ({type(tf).__name__}) have per-output "
                         "weight tensors with no kernel form in the fused vector filter")
    xi = _host(tf.points)
    if xi.shape[0] != dim_in:
        raise ValueError(f"transform dimension {xi.shape[0]} != expected {dim_in}")
    if tf.model_var.numel() != 1:
        raise ValueError("the fused vector filter needs a scalar model variance; got "
                         f"one of shape {tuple(tf.model_var.shape)}")
    return VecRule(kind=1, xi=xi, wm=_host(tf.wm), Wc=_host(tf.Wc), Wcc=_host(tf.Wcc),
                   emv=float(tf.model_var.reshape(())))


def _forms(mod_dyn, mod_obs):
    """The kernel forms of both models (:func:`~.forms.find_dyn`,
    :func:`~.forms.find_obs`); ``ValueError`` naming a model without one."""
    found = find_dyn(mod_dyn, _DYN_MODELS), find_obs(mod_obs, _OBS_MODELS)
    for model, form in zip((mod_dyn, mod_obs), found):
        if form is None:
            raise ValueError(f"the fused vector filter has no kernel form of "
                             f"{type(model).__name__} (register one: register_dyn_dd_vec / "
                             "register_obs_dd_vec, or scalar_filter.register_dyn_dd / "
                             "register_obs_dd)")
    return found


def check(mod_dyn, mod_obs, tf_dyn, tf_obs):
    """Raise ``ValueError`` with the reason the fused vector filter cannot run
    this configuration (in the order of ``ddvec.dd_check``); return None when
    it can."""
    D = mod_dyn.dim_state
    if D > _MAX_DIM:
        raise ValueError(f"the fused vector filter takes dim_state <= {_MAX_DIM}; got {D}")
    if not (mod_dyn.noise_additive and mod_obs.noise_additive):
        raise ValueError("the fused vector filter requires additive process and "
                         "measurement noise")
    dyn, _ = _forms(mod_dyn, mod_obs)
    if D < 2 or dyn == "ungm":
        raise ValueError(f"the fused vector filter takes dim_state >= 2; got {D} (1-D states "
                         "run in the scalar filter kernel, ops.scalar_filter)")
    lower_transform(tf_dyn, D)
    lower_transform(tf_obs, D)


def supports(mod_dyn, mod_obs, tf_dyn, tf_obs) -> bool:
    """True if the fused vector filter can run this configuration: the
    answer of ``ddvec.dd_supports`` on states of 2-8 dimensions, under the
    same registrations."""
    try:
        check(mod_dyn, mod_obs, tf_dyn, tf_obs)
    except ValueError:
        return False
    return True


@dataclass(frozen=True)
class VectorFilterParams:
    """Everything the kernel takes besides the measurements; matrices as
    row-major tuples.  Hashable: the parameter struct is cached by it.  A
    registered model's form stands in ``dyn_form`` / ``obs_form`` (its model
    id then -1, its constants in ``dyn_c`` / ``obs_c``); ``obs_index``: the
    state component a scalar-registry form reads; ``streams(n_steps)``: a
    registered transition's ``n_s`` per-step streams, (n_steps, n_s)."""

    dyn: VecRule
    obs: VecRule
    dyn_model: int
    obs_model: int
    dim_state: int
    dim_out: int
    dyn_c: tuple
    obs_c: tuple
    obs_idx: tuple
    m0: tuple
    P0: tuple
    gqg: tuple
    r: tuple
    dyn_form: KernelForm | None = None
    obs_form: KernelForm | None = None
    obs_index: int | None = None
    n_s: int = 0
    streams: object = field(default=None, compare=False)
    _on: dict = field(default_factory=dict, compare=False, repr=False)


def prepare(mod_dyn, mod_obs, tf_dyn, tf_obs, init_mean=None, init_cov=None
            ) -> VectorFilterParams:
    """Lower a configuration to :class:`VectorFilterParams` (``ddvec._prepare``):
    the two rules, the models' forms and constants, the initial moments (or
    ``init_mean`` / ``init_cov``), ``G Q G^T`` and ``R``.  ``ValueError``
    names the piece the kernel cannot run."""
    check(mod_dyn, mod_obs, tf_dyn, tf_obs)
    D, E = mod_dyn.dim_state, mod_obs.dim_out
    dyn, obs = _forms(mod_dyn, mod_obs)
    (m0_t, P0_t), q_t = mod_dyn.init_rv.get_stats()[:2], mod_dyn.noise_rv.get_stats()[1]
    r_t = mod_obs.noise_rv.get_stats()[1]

    def dyn_consts():
        G = np.atleast_2d(_host(mod_dyn.noise_gain))
        GQG = G @ np.atleast_2d(_host(q_t)) @ G.T
        return _floats(m0_t.reshape(D)), _floats(P0_t.reshape(D, D)), _floats(GQG.reshape(D, D))

    m0, P0, gqg = _memo(mod_dyn, "_vector_filter_consts", (m0_t, P0_t, q_t, mod_dyn.noise_gain),
                        dyn_consts)
    r = _memo(mod_obs, "_vector_filter_r", (r_t,), lambda: _floats(r_t.reshape(E, E)))
    if isinstance(dyn, Registered):
        dyn_id, dyn_c = -1, dyn.form.consts
    else:
        dyn_id, dyn_c = dyn[0], tuple(float(c) for c in dyn[1](mod_dyn))
    idx = (0, 0)
    if isinstance(obs, Registered):
        obs_id, obs_c = -1, obs.form.consts
    else:
        obs_id, obs_src = obs if obs != "ungm" else _OBS_MODELS[UNGMMeasurement]
        c_src = obs_src(mod_obs)
        obs_c = (_memo(mod_obs, "_vector_filter_c", (c_src,), lambda: _floats(c_src))
                 if isinstance(c_src, torch.Tensor) else _floats(c_src))
        sub = mod_obs.dim_substate
        idx = mod_obs.state_index if mod_obs.state_index is not None else tuple(range(sub))
        if len(idx) < sub or max(idx[:sub]) >= D:
            raise ValueError(f"state_index {idx} does not pick the {sub} component(s) "
                             f"{type(mod_obs).__name__} reads from a state of dimension {D}")
        idx = tuple(int(i) for i in idx[:sub])
    if init_mean is not None:
        m0 = _floats(np.reshape(_floats(init_mean), D))
    if init_cov is not None:
        P0 = _floats(np.reshape(_floats(init_cov), (D, D)))
    reg_dyn, reg_obs = (f if isinstance(f, Registered) else None for f in (dyn, obs))
    return VectorFilterParams(
        dyn=lower_transform(tf_dyn, D), obs=lower_transform(tf_obs, D),
        dyn_model=dyn_id, obs_model=obs_id, dim_state=D, dim_out=E, dyn_c=dyn_c, obs_c=obs_c,
        obs_idx=idx, m0=m0, P0=P0, gqg=gqg, r=r,
        dyn_form=reg_dyn and reg_dyn.form, obs_form=reg_obs and reg_obs.form,
        obs_index=reg_obs and reg_obs.index, n_s=reg_dyn.n_s if reg_dyn else 0,
        streams=reg_dyn and reg_dyn.streams)


def _instantiated(params: VectorFilterParams) -> bool:
    """Whether the first version and the shaped kernels have an
    instantiation of ``params``' model pair (``_PAIRS``, bearings from
    ``_BEARING_SENSORS`` sensors)."""
    return ((params.dyn_model, params.obs_model) in _PAIRS
            and (params.obs_model != 3 or params.dim_out == _BEARING_SENSORS))


def _registered_pair(params: VectorFilterParams) -> bool:
    return params.dyn_form is not None or params.obs_form is not None


def _shaped_counts(params: VectorFilterParams) -> bool:
    """Whether each rule has the UT or the CKF point count of the state
    (2 D + 1 or 2 D), the counts of the shaped kernels and forms."""
    D = params.dim_state
    return params.dyn.n in (2 * D, 2 * D + 1) and params.obs.n in (2 * D, 2 * D + 1)


def _gh_count(D: int) -> int:
    """``vfs_gh_count`` of the shaped kernel's header: the Gauss-Hermite
    count p^D (p >= 2) of at most :data:`_SHAPED_MAX_PTS` points that is
    neither 2 D + 1 nor 2 D (9 on a 2-D state, 8 on a 3-D one), 0 if none."""
    for p in range(2, _SHAPED_MAX_PTS + 1):
        if p ** D > _SHAPED_MAX_PTS:
            return 0
        if p ** D not in (2 * D, 2 * D + 1):
            return p ** D
    return 0


def _shaped_gh(params: VectorFilterParams) -> bool:
    """Whether both rules are classical with the Gauss-Hermite count of
    :func:`_gh_count`, which the shaped kernel and forms take beside the UT
    and CKF counts (a BQ rule at that count keeps its route)."""
    n = _gh_count(params.dim_state)
    return (n > 0 and params.dyn.n == params.obs.n == n
            and params.dyn.kind == params.obs.kind == 0)


def slot_lanes(params: VectorFilterParams) -> int:
    """The lanes a trajectory of the slot design runs on for ``params``, 0
    if it has no instantiation of it.  A table pair: the slot kernel's
    (``vector_filter_slots``), the header's answer (``vsl_lanes_of`` of
    ``csrc/vector_filter_slots.cuh``, via :func:`_fit`), where the shapes
    (``VSL_SHAPES``, the five pairs; ``VSL_GENERAL``, the general kernel's)
    and the lanes of each are those the card chose (PERF.md, section 6).  A
    registered configuration: the registered kernel's slot form's, the
    design :func:`_slot_design` names."""
    if _registered_pair(params):
        return _slot_design(params)[0]
    return int(_fit().vsl_lanes_on(ctypes.byref(_c_params(params, torch.device("cpu")))))


def _slot_design(params: VectorFilterParams) -> tuple:
    """``(G, split, keep)`` of the registered kernel's slot form for a
    registered configuration (``G`` 0 where the form does not take it): at
    most 4 measurement outputs on a state of 2-5 dimensions, both rules
    classical with the same count, at most :data:`_VGS_MAX_C` constants a
    form, and a design of the header's rule for (D, E, N) (``vsr_design``:
    the design of the table's slot shape of the same D and N with the
    nearest E)."""
    D, E, n = params.dim_state, params.dim_out, params.dyn.n
    if not (2 <= D <= _SLOT_MAX_DIM and E <= 4 and params.dyn.kind == params.obs.kind == 0
            and n == params.obs.n and n <= _SLOT_MAX_PTS and all(
                len(f.consts) <= _VGS_MAX_C for f in (params.dyn_form, params.obs_form)
                if f is not None)):
        return 0, False, False
    out = (ctypes.c_int * 3)()
    _fit().vsr_design_on(D, E, n, out)
    return out[0], bool(out[1]), bool(out[2])


def kernel_of(params: VectorFilterParams) -> str:
    """The kernel that runs ``params``.  A registered model on either side:
    ``"vector_filter_registered"`` (in its slot form, :func:`lanes_of`, at
    the Gauss-Hermite counts of 16-81 points the table's slot shapes have).
    A model pair that the first version and the shaped kernels do not
    instantiate: ``"vector_filter_slots"`` where both rules are classical
    with a count of 16-81 points that the slot kernel instantiates for it
    (:func:`slot_lanes`: GH-4 on the 2-D pairs of ``VGS_PAIRS``, GH-3 and
    GH-4 on the 3-D ones, GH-2 and GH-3 on the 4-D ones, GH-2 on the 5-D
    ones, ``VSL_GENERAL``), else ``"vector_filter_general"`` (GH-3 on 5-D
    states, 243 points, in its warp form; other degrees such as GH-5 on 2-D
    states, BQ rules at any Gauss-Hermite count and mixed counts in its
    one-thread form).  Else, each rule at the UT or CKF count (2 D + 1 or 2 D points, one
    count on both transforms or the two mixed): both classical,
    ``"vector_filter_shaped"``; a BQ rule on either or both,
    ``"vector_filter_shaped_bq"``.  Both classical at the Gauss-Hermite count
    of at most 11 points (:func:`_shaped_gh`): ``"vector_filter_shaped"``.
    Both classical at a count of 16-81 points that the slot kernel
    instantiates (:func:`slot_lanes`: GH-2 and GH-3 on the pairs the card
    showed faster there): ``"vector_filter_slots"``.  Rules that the warp
    form takes (:func:`_warp_takes`: Gauss-Hermite on 5-D states):
    ``"vector_filter_general"`` in that form.  Any other count:
    ``"vector_filter"``, the first version."""
    dyn, obs = params.dyn, params.obs
    if _registered_pair(params):
        return "vector_filter_registered"
    if not _instantiated(params):
        return "vector_filter_slots" if slot_lanes(params) else "vector_filter_general"
    if _shaped_counts(params):
        return "vector_filter_shaped" if dyn.kind == obs.kind == 0 else "vector_filter_shaped_bq"
    if _shaped_gh(params):
        return "vector_filter_shaped"
    if slot_lanes(params):
        return "vector_filter_slots"
    return "vector_filter_general" if _warp_takes(params) else "vector_filter"


def _form_fit(params: VectorFilterParams, lanes: int) -> tuple:
    """How ``params`` runs on ``lanes`` lanes (:data:`_LANES`, or
    :data:`_WARP`: the warp form), as the header reckons it (``vfl_fit`` via
    :func:`_fit`): trajectories a block (0 where the launcher refuses it),
    doubles a block stages, doubles a trajectory, warps an SM."""
    out = (ctypes.c_int * 4)()
    _fit().vfl_fit_on(ctypes.byref(_c_params(params, torch.device("cpu"))), lanes, out)
    return tuple(out)


def _warp_takes(params: VectorFilterParams) -> bool:
    """Whether the warp form runs ``params``: both rules of at least
    :data:`_WARP_MIN_POINTS` points, and an SM holds at least
    :data:`_MIN_LANE_WARPS` warps of it."""
    return (min(params.dyn.n, params.obs.n) >= _WARP_MIN_POINTS
            and _form_fit(params, _WARP)[3] >= _MIN_LANE_WARPS)


def _shaped_takes(params: VectorFilterParams) -> bool:
    """Whether the shaped one-thread form (``vgs_record`` of
    ``csrc/vector_filter_general_shaped.cuh``) runs ``params``: at most 4
    measurement outputs on a state of 2-5 dimensions, each rule with 2 D + 1
    or 2 D points, or both classical with the Gauss-Hermite count of
    :func:`_shaped_gh`; for the general kernel a pair and rules it
    instantiates (``vgs_takes`` of the header, via :func:`_fit`: a pair of
    ``VGS_PAIRS``, both rules classical, one count on both, the two mixed or
    the Gauss-Hermite count of ``VGS_GH``), for the registered kernel rules
    of either kind at one UT or CKF count on both, classical rules at the
    two mixed or at the Gauss-Hermite count (a BQ rule at mixed counts keeps
    the one-thread form), and registered constants that its parameters hold
    (:data:`_VGS_MAX_C`)."""
    if not (2 <= params.dim_state <= _SHAPED_MAX_DIM and params.dim_out <= 4
            and (_shaped_counts(params) or _shaped_gh(params))):
        return False
    if _registered_pair(params):
        return (params.obs.n == params.dyn.n or params.dyn.kind == params.obs.kind == 0) and all(
            len(f.consts) <= _VGS_MAX_C for f in (params.dyn_form, params.obs_form)
            if f is not None)
    return bool(_fit().vgs_takes_on(ctypes.byref(_c_params(params, torch.device("cpu")))))


def lanes_of(params: VectorFilterParams) -> int:
    """The lanes a trajectory of the general and registered kernels runs on.
    :data:`_SLOTS` for a registered configuration the registered kernel's
    slot form takes (:func:`slot_lanes`: both rules classical at a
    Gauss-Hermite count of 16-81 points of the table's slot shapes, up to 4
    outputs on 2-5-D states; its lanes the design's).
    :data:`_WARP`, the warp form (``vfl_step`` on a whole warp), where both
    rules have at least :data:`_WARP_MIN_POINTS` points and an SM holds at
    least :data:`_MIN_LANE_WARPS` warps of it (:func:`_warp_takes`).  The
    threshold is the card's (NVIDIA H100 80GB HBM3 at 700 W, raw launches at
    10,000 x 100 in turns, ``tools/lane_variants.py``, PERF.md section 6, PR
    22): under GH-3 the warp form took 5.0 ms on the falling body (27
    points) against the first version's 1.6, 11.7 ms on constant velocity
    with the radar (81) against 9.9, and 37.9 ms on CT with 4 bearings
    (243) against 71.0; so 243 (between 81 and 243 not measured).  For at
    most 4 measurement outputs on a state of at most 5 dimensions, one thread
    a trajectory: :data:`_SHAPED`, the shaped form (``vgs_record``), where it
    takes the shape (:func:`_shaped_takes`: the general kernel's UKF beside
    its CKF too, and GH-3 on 2-D or GH-2 on 3-D states), else 0, the general
    one-thread form (``vfg_step``; mixed counts with a BQ rule, Gauss-Hermite
    rules of 12-242 points that neither the slot design nor the warp form
    takes (GH-5 on a 2-D state, say), BQ rules at a Gauss-Hermite count).  The
    table's Gauss-Hermite shapes of 16-81 points run in the slot kernel
    (``kernel_of``), GH-3 on 5-D states in the warp form.  The shaped form keeps 3 and
    4 outputs too: raw launches at 10,000 x 100 in turns (NVIDIA H100 80GB
    HBM3 at 700 W, ``tools/lane_variants.py``, PERF.md section 6), CT + 3
    bearings CKF 2.13 ms against 2.36 in the lane-group form on 8 lanes and
    3.17 in the general one-thread form, the falling body with 4 bearings
    CKF 1.06 against 1.49-1.55.  0 too for every shape of the other kernels
    (the slot kernel's lanes: :func:`slot_lanes`).  Above
    that the lane-group form (``vfl_step`` of
    ``csrc/vector_filter_lanes.cuh``) on :data:`_LANES` lanes where an SM
    holds any warp of it (a warp's trajectories' arrays fit in a block's
    shared memory: not a registered 8-D state under Gauss-Hermite rules,
    say) and, for at most 8 outputs, where the one-thread form keeps its
    arrays in registers, at least :data:`_MIN_LANE_WARPS` (not under rules
    of some hundreds of points), as the header reckons them
    (:func:`_form_fit`); else 0 again."""
    kernel = kernel_of(params)
    if kernel not in ("vector_filter_general", "vector_filter_registered"):
        return 0
    if kernel == "vector_filter_registered" and slot_lanes(params):
        return _SLOTS
    if _warp_takes(params):
        return _WARP
    if params.dim_out <= 4 and params.dim_state <= 5:
        return _SHAPED if _shaped_takes(params) else 0
    warps = _form_fit(params, _LANES)[3]
    return _LANES if warps >= (_MIN_LANE_WARPS if params.dim_out <= 8 else 1) else 0


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-dim tensor beside ``like``: a division by it rounds once
    (PyTorch divides a CUDA tensor by a Python number as a multiplication by
    its reciprocal, and ``number / tensor`` as ``tensor.reciprocal() *
    number``)."""
    return torch.tensor(v, dtype=torch.float64, device=like.device)


def _streams_on(params: VectorFilterParams, T: int, device) -> torch.Tensor:
    """A registered transition's per-step streams of a T-step record,
    (T, n_s), on ``device``; (T, 0) for a table transition (beside a
    registered measurement), which reads none."""
    if params.streams is None:
        return torch.empty((T, 0), dtype=torch.float64, device=device)
    return forms.on_device(params._on, f"streams_{T}", device, lambda: params.streams(T))


def _dyn_plain(params: VectorFilterParams, x: torch.Tensor, fns, s=None) -> torch.Tensor:
    """The dynamics at zero noise on states ``x`` (..., D), as the step header
    evaluates them; ``s``: a registered transition's stream values of this
    step."""
    c = params.dyn_c
    if params.dyn_form is not None:
        return params.dyn_form.plain(x, forms.on_device(params._on, "dyn_c", x.device, lambda: c),
                                     s, fns)
    if params.dyn_model == 1:
        x0, x1, x2, x3 = x.unbind(-1)
        return torch.stack([x0 + c[0] * x1, x1, x2 + c[0] * x3, x3], dim=-1)
    if params.dyn_model == 2:
        x0, x1 = x.unbind(-1)
        return torch.stack([x0 + x1 * c[0], x1 - c[1] * fns.sin(x0)], dim=-1)
    if params.dyn_model == 3:
        x0, x1, x2 = x.unbind(-1)
        return torch.stack([x0 - c[0] * x1,
                            x1 - ((c[0] * fns.exp(c[1] * x0)) * (x1 * x1)) * x2, x2], dim=-1)
    if params.dyn_model == 4:
        x0, x1, x2, x3, om = x.unbind(-1)
        straight = om.abs() < 1e-30
        om_safe = torch.where(straight, 1e-30, om)
        a, b = fns.sin(om * c[0]), fns.cos(om * c[0])
        cc = torch.where(straight, c[0], a / om_safe)
        d = torch.where(straight, 0.0, (1.0 - b) / om_safe)
        return torch.stack([x0 + cc * x1 - d * x3, b * x1 - a * x3, x2 + d * x1 + cc * x3,
                            a * x1 + b * x3, om], dim=-1)
    dt, R0, H0, Gm0, b0 = c
    x0, x1, x2, x3, x4 = x.unbind(-1)
    R = fns.sqrt(x0 * x0 + x1 * x1)
    V = fns.sqrt(x2 * x2 + x3 * x3)
    drag = (b0 * fns.exp(x4 + torch.div(R0 - R, _const(H0, x)))) * V
    grav = torch.div(_const(-Gm0, x), (R * R) * R)
    return torch.stack([x0 + dt * x2, x1 + dt * x3, x2 + dt * (drag * x2 + grav * x0),
                        x3 + dt * (drag * x3 + grav * x1), x4], dim=-1)


def _obs_plain(params: VectorFilterParams, x: torch.Tensor, fns) -> torch.Tensor:
    """The measurement at zero noise of states ``x`` (..., D), as the step
    header evaluates it."""
    c, first = params.obs_c, x[..., params.obs_idx[0]]
    if params.obs_form is not None:
        if params.obs_index is not None:
            x = x[..., params.obs_index:params.obs_index + 1]
        return params.obs_form.plain(x, forms.on_device(params._on, "obs_c", x.device, lambda: c),
                                     fns)
    if params.obs_model == 1:
        return fns.sin(first)[..., None]
    if params.obs_model == 4:
        return (0.05 * (first * first))[..., None]
    if params.obs_model == 2:
        d = first - c[1]
        return fns.sqrt(c[0] + d * d)[..., None]
    second = x[..., params.obs_idx[1]]
    if params.obs_model == 3:
        return torch.stack([fns.atan2(second - c[2 * s + 1], first - c[2 * s])
                            for s in range(len(c) // 2)], dim=-1)
    dx, dy = first - c[0], second - c[1]
    return torch.stack([fns.sqrt(dx * dx + dy * dy), fns.atan2(dy, dx)], dim=-1)


def _chol_plain(A: torch.Tensor, sqrt) -> torch.Tensor:
    """Lower Cholesky factor of the lower triangle of each (n, n) matrix of
    ``A`` (B, n, n), the step header's recurrence; NaN where it fails."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for i in range(n):
        for j in range(i + 1):
            s = A[:, i, j]
            for k in range(j):
                s = s - L[:, i, k] * L[:, j, k]
            L[:, i, j] = sqrt(s) if i == j else s / L[:, j, j]
    return L


def _mirror(S: torch.Tensor) -> torch.Tensor:
    """``S`` with its upper triangle copied from the lower one."""
    n = S.shape[-1]
    iu = torch.triu_indices(n, n, 1, device=S.device)
    S[:, iu[0], iu[1]] = S[:, iu[1], iu[0]]
    return S


def _moments_plain(rule: VecRule, m: torch.Tensor, L: torch.Tensor, f):
    """``(mu, cov, cross)`` of ``f`` over ``rule`` at the Gaussians (m, L L^T)
    of a batch, ``m`` (B, D), ``L`` (B, D, D); every sum in the step header's
    order, over the points one at a time."""
    dev, (B, D) = m.device, m.shape
    xi = torch.as_tensor(rule.xi, device=dev)
    n = rule.n
    dx = torch.zeros((n, B, D), dtype=m.dtype, device=dev)
    for k in range(D):
        dx[:, :, k:] = dx[:, :, k:] + L[:, k:, k][None] * xi[k][:, None, None]
    fx = f(m[None] + dx)                                                # (n, B, EO)
    mu = torch.zeros_like(fx[0])
    for j in range(n):
        mu = mu + float(rule.wm[j]) * fx[j]
    if rule.kind == 0:
        cov = torch.zeros(fx.shape[1:] + fx.shape[-1:], dtype=m.dtype, device=dev)
        cross = torch.zeros(fx.shape[1:] + (D,), dtype=m.dtype, device=dev)
        for j in range(n):
            d, w = fx[j] - mu, float(rule.wc[j])
            cov = cov + w * (d[:, :, None] * d[:, None, :])
            cross = cross + w * (d[:, :, None] * dx[j][:, None, :])
        return mu, _mirror(cov), cross
    Wc, Wcc = torch.as_tensor(rule.Wc, device=dev), torch.as_tensor(rule.Wcc, device=dev)
    g = torch.zeros_like(fx)                                            # g_i = sum_j Wc_ij f_j
    for j in range(n):
        g = g + Wc[:, j][:, None, None] * fx[j][None]
    q = torch.zeros(fx.shape[1:] + fx.shape[-1:], dtype=m.dtype, device=dev)
    h = torch.zeros(fx.shape[1:] + (D,), dtype=m.dtype, device=dev)   # h[e][a]
    for i in range(n):
        q = q + fx[i][:, :, None] * g[i][:, None, :]
        h = h + Wcc[:, i][None, None, :] * fx[i][:, :, None]
    cov = q - mu[:, :, None] * mu[:, None, :]
    cov.diagonal(dim1=1, dim2=2).add_(rule.emv)
    cross = torch.zeros_like(h)
    for a in range(D):
        cross[:, :, a:] = cross[:, :, a:] + h[:, :, a:a + 1] * L[:, a:, a][:, None, :]
    return mu, _mirror(cov), cross


def _empty_streams(D: int, T: int, B: int, device) -> tuple:
    """The five time-major output streams, views of one buffer: ``m_fi``,
    ``m_pr`` (T, D, B) and ``P_fi``, ``P_pr``, ``xx`` (T, D, D, B), in the
    order ``(m_fi, P_fi, m_pr, P_pr, xx)``."""
    v, M = T * D * B, T * D * D * B
    buf = torch.empty(2 * v + 3 * M, dtype=torch.float64, device=device)
    m_fi, m_pr, P_fi, P_pr, xx = buf.split([v, v, M, M, M])
    vec, mat = (T, D, B), (T, D, D, B)
    return m_fi.view(vec), P_fi.view(mat), m_pr.view(vec), P_pr.view(mat), xx.view(mat)


def _vector_filter_plain(params: VectorFilterParams, y: torch.Tensor, fns=TORCH_FNS):
    """The kernel's computation as batched torch operations over the B
    trajectories and a Python loop over the T steps; same arguments and
    results as :func:`vector_filter`, for every kernel (a registered model
    through its form's ``plain``).  ``fns``: the transcendentals to take,
    ``sqrt``, ``exp``, ``sin``, ``cos`` and ``atan2`` (:data:`TORCH_FNS` by
    default)."""
    B, E, T = y.shape
    D, dev = params.dim_state, y.device
    out = _empty_streams(D, T, B, dev)
    m = torch.tensor(params.m0, dtype=torch.float64, device=dev).expand(B, D)
    P = torch.tensor(params.P0, dtype=torch.float64, device=dev).reshape(D, D).expand(B, D, D)
    gqg = torch.tensor(params.gqg, dtype=torch.float64, device=dev).reshape(D, D)
    r = torch.tensor(params.r, dtype=torch.float64, device=dev).reshape(E, E)
    streams = _streams_on(params, T, dev) if params.dyn_form is not None else None
    for k in range(T):
        s = None if streams is None else streams[k]
        m_pr, Pf, xx = _moments_plain(params.dyn, m, _chol_plain(P, fns.sqrt),
                                      lambda x: _dyn_plain(params, x, fns, s))
        P_pr = Pf + gqg
        y_pr, S, C = _moments_plain(params.obs, m_pr, _chol_plain(P_pr, fns.sqrt),
                                    lambda x: _obs_plain(params, x, fns))
        S = S + r
        Ls = _chol_plain(S, fns.sqrt)
        z = torch.empty_like(C)                                          # (B, E, D)
        for i in range(E):
            s = C[:, i]
            for k2 in range(i):
                s = s - Ls[:, i, k2, None] * z[:, k2]
            z[:, i] = s / Ls[:, i, i, None]
        K = torch.empty_like(C)                                          # K^T: (B, E, D)
        for i in range(E - 1, -1, -1):
            s = z[:, i]
            for k2 in range(i + 1, E):
                s = s - Ls[:, k2, i, None] * K[:, k2]
            K[:, i] = s / Ls[:, i, i, None]
        dy = y[:, :, k] - y_pr
        m_fi = m_pr
        for e in range(E):
            m_fi = m_fi + K[:, e] * dy[:, e, None]
        Tm = torch.zeros_like(K)                                         # (K S)^T: (B, E, D)
        for e2 in range(E):
            Tm = Tm + K[:, e2][:, None, :] * S[:, e2][:, :, None]
        acc = torch.zeros_like(P_pr)
        for e in range(E):
            acc = acc + Tm[:, e][:, :, None] * K[:, e][:, None, :]
        P_fi = torch.tril(P_pr - acc)
        P_fi = _mirror(P_fi)
        for o, v in zip(out, (m_fi, P_fi, m_pr, P_pr, xx)):
            o[k] = v.movedim(0, -1)
        m, P = m_fi, P_fi
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class _CRule(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("n", ctypes.c_int), ("xi", ctypes.c_void_p),
                ("wm", ctypes.c_void_p), ("wc", ctypes.c_void_p), ("Wc", ctypes.c_void_p),
                ("Wcc", ctypes.c_void_p), ("emv", ctypes.c_double)]


class _CParams(ctypes.Structure):
    _fields_ = [("dyn", _CRule), ("obs", _CRule), ("dyn_model", ctypes.c_int),
                ("obs_model", ctypes.c_int), ("dim_state", ctypes.c_int),
                ("dim_out", ctypes.c_int), ("dyn_c", ctypes.c_double * 5),
                ("obs_c", ctypes.c_double * _MAX_OBS_C), ("obs_idx", ctypes.c_int * 2),
                ("m0", ctypes.c_double * _MAX_DIM),
                ("P0", ctypes.c_double * (_MAX_DIM * _MAX_DIM)),
                ("gqg", ctypes.c_double * (_MAX_DIM * _MAX_DIM)),
                ("r", ctypes.c_double * (_MAX_DIM * _MAX_DIM))]


def _c_rule(rule: VecRule, dim_in: int, device: torch.device) -> _CRule:
    base, n = rule.packed(device).data_ptr(), rule.n
    xi, wm = base, base + 8 * dim_in * n
    after = wm + 8 * n
    if rule.kind == 0:
        return _CRule(kind=0, n=n, xi=xi, wm=wm, wc=after)
    return _CRule(kind=1, n=n, xi=xi, wm=wm, Wc=after, Wcc=after + 8 * n * n, emv=rule.emv)


def _square(vals: tuple, n: int, into):
    for i in range(n):
        into[i * _MAX_DIM:i * _MAX_DIM + n] = vals[i * n:(i + 1) * n]


@functools.lru_cache(maxsize=64)
def _c_params(p: VectorFilterParams, device: torch.device) -> _CParams:
    """The kernel's parameter struct for the rules' constants on ``device``,
    built once for a given ``(p, device)``.  A table measurement's constants
    and R stand in it where they fit (the general kernels' other forms read
    them from device memory, :func:`_c_general`), a table transition's
    constants always."""
    D, E = p.dim_state, p.dim_out
    c = _CParams(dyn=_c_rule(p.dyn, D, device), obs=_c_rule(p.obs, D, device),
                 dyn_model=p.dyn_model, obs_model=p.obs_model, dim_state=D, dim_out=E)
    if p.dyn_form is None:
        c.dyn_c[:len(p.dyn_c)] = p.dyn_c
    if p.obs_form is None and len(p.obs_c) <= _MAX_OBS_C:
        c.obs_c[:len(p.obs_c)] = p.obs_c
    if E <= _MAX_DIM:
        _square(p.r, E, c.r)
    c.obs_idx[:len(p.obs_idx)] = p.obs_idx
    c.m0[:D] = p.m0
    _square(p.P0, D, c.P0)
    _square(p.gqg, D, c.gqg)
    return c


class _CGParams(ctypes.Structure):
    """``VfgParams``: the general kernels' parameters."""
    _fields_ = [("base", _CParams), ("obs_c", ctypes.c_void_p), ("r", ctypes.c_void_p),
                ("dyn_c", ctypes.c_void_p)]


@functools.lru_cache(maxsize=64)
def _c_general(p: VectorFilterParams, device: torch.device) -> _CGParams:
    """The general kernels' parameter struct: :func:`_c_params` and the
    measurement's constants, R and a registered transition's constants
    copied to ``device`` (kept alive on the struct); built once for a given
    ``(p, device)``."""
    keep = tuple(torch.tensor(v or (0.0,), dtype=torch.float64, device=device)
                 for v in (p.obs_c, p.r, p.dyn_c if p.dyn_form is not None else ()))
    c = _CGParams(base=_c_params(p, device), obs_c=keep[0].data_ptr(), r=keep[1].data_ptr(),
                  dyn_c=keep[2].data_ptr())
    c.keep = keep
    return c


class _CShapedRule(ctypes.Structure):
    _fields_ = [("xi", ctypes.c_double * (_SHAPED_MAX_DIM * _SHAPED_MAX_PTS)),
                ("wm", ctypes.c_double * _SHAPED_MAX_PTS),
                ("wc", ctypes.c_double * _SHAPED_MAX_PTS)]


class _CShapedParams(ctypes.Structure):
    _fields_ = [("base", _CParams), ("dyn", _CShapedRule), ("obs", _CShapedRule)]


def _rows(a: np.ndarray, into):
    """The rows of ``a`` into ``into``, ``_SHAPED_MAX_PTS`` apart."""
    for d, row in enumerate(a):
        into[d * _SHAPED_MAX_PTS:d * _SHAPED_MAX_PTS + len(row)] = row.tolist()


def _fits_shaped(rule: VecRule, kinds: tuple, takes: str):
    """``ValueError`` (``takes``: what the struct takes) unless ``rule`` is of
    one of ``kinds`` and fits the shaped structs (``VFS_MAX_PTS`` points,
    ``VFS_MAX_DIM`` inputs)."""
    if rule.kind not in kinds or rule.n > _SHAPED_MAX_PTS or rule.xi.shape[0] > _SHAPED_MAX_DIM:
        raise ValueError(f"{takes} of up to {_SHAPED_MAX_PTS} points in up to {_SHAPED_MAX_DIM} "
                         f"dimensions; got kind {rule.kind}, {rule.xi.shape}")


def _c_shaped_rule(rule: VecRule) -> _CShapedRule:
    """A classical rule by value; ``ValueError`` for a rule the struct
    cannot hold."""
    _fits_shaped(rule, (0,), "the shaped kernel takes classical rules")
    c = _CShapedRule()
    _rows(rule.xi, c.xi)
    c.wm[:rule.n] = rule.wm.tolist()
    c.wc[:rule.n] = rule.wc.tolist()
    return c


@functools.lru_cache(maxsize=64)
def _c_shaped_params(p: VectorFilterParams, device: torch.device) -> _CShapedParams:
    """The shaped kernel's parameter struct (both rules by value), built once
    for a given ``(p, device)``."""
    return _CShapedParams(base=_c_params(p, device), dyn=_c_shaped_rule(p.dyn),
                          obs=_c_shaped_rule(p.obs))


class _CShapedBqRule(ctypes.Structure):
    _fields_ = [("c", _CShapedRule), ("Wc", ctypes.c_double * (_SHAPED_MAX_PTS * _SHAPED_MAX_PTS)),
                ("Wcc", ctypes.c_double * (_SHAPED_MAX_DIM * _SHAPED_MAX_PTS)),
                ("emv", ctypes.c_double)]


class _CShapedBqParams(ctypes.Structure):
    _fields_ = [("base", _CParams), ("dyn", _CShapedBqRule), ("obs", _CShapedBqRule)]


def _c_shaped_bq_rule(rule: VecRule) -> _CShapedBqRule:
    """A rule of either kind by value for the kernel of the BQ shapes (a
    classical rule's ``wc``, a BQ rule's ``Wc`` (whole: the port's GPQ
    weights are not symmetric to the bit), ``Wcc`` and ``emv``);
    ``ValueError`` for a rule the struct cannot hold."""
    _fits_shaped(rule, (0, 1), "the kernel of the BQ shapes takes classical and BQ rules")
    c = _CShapedBqRule()
    _rows(rule.xi, c.c.xi)
    c.c.wm[:rule.n] = rule.wm.tolist()
    if rule.kind == 0:
        c.c.wc[:rule.n] = rule.wc.tolist()
    else:
        _rows(rule.Wc, c.Wc)
        _rows(rule.Wcc, c.Wcc)
        c.emv = rule.emv
    return c


@functools.lru_cache(maxsize=64)
def _c_shaped_bq_params(p: VectorFilterParams, device: torch.device) -> _CShapedBqParams:
    """The parameter struct of the kernel of the BQ shapes (both rules by
    value), built once for a given ``(p, device)``."""
    return _CShapedBqParams(base=_c_params(p, device), dyn=_c_shaped_bq_rule(p.dyn),
                            obs=_c_shaped_bq_rule(p.obs))


class _CSlotRule(ctypes.Structure):
    """``VslRule``: a classical rule of up to :data:`_SLOT_MAX_PTS` points by
    value, rows :data:`_SLOT_MAX_PTS` apart."""
    _fields_ = [("xi", ctypes.c_double * (_SLOT_MAX_DIM * _SLOT_MAX_PTS)),
                ("wm", ctypes.c_double * _SLOT_MAX_PTS),
                ("wc", ctypes.c_double * _SLOT_MAX_PTS)]


class _CSlotParams(ctypes.Structure):
    """``VslParams``: the slot kernel's parameters."""
    _fields_ = [("base", _CParams), ("dyn", _CSlotRule), ("obs", _CSlotRule)]


def _c_slot_rule(rule: VecRule) -> _CSlotRule:
    """A classical rule by value for the slot kernel; ``ValueError`` for a
    rule the struct cannot hold."""
    if rule.kind != 0 or rule.n > _SLOT_MAX_PTS or rule.xi.shape[0] > _SLOT_MAX_DIM:
        raise ValueError(f"the slot kernel takes classical rules of up to {_SLOT_MAX_PTS} "
                         f"points in up to {_SLOT_MAX_DIM} dimensions; got kind {rule.kind}, "
                         f"{rule.xi.shape}")
    c = _CSlotRule()
    for d, row in enumerate(rule.xi):
        c.xi[d * _SLOT_MAX_PTS:d * _SLOT_MAX_PTS + len(row)] = row.tolist()
    c.wm[:rule.n] = rule.wm.tolist()
    c.wc[:rule.n] = rule.wc.tolist()
    return c


@functools.lru_cache(maxsize=64)
def _c_slot_params(p: VectorFilterParams, device: torch.device) -> _CSlotParams:
    """The slot kernel's parameter struct (both rules by value), built once
    for a given ``(p, device)``."""
    return _CSlotParams(base=_c_params(p, device), dyn=_c_slot_rule(p.dyn),
                        obs=_c_slot_rule(p.obs))


class _CSlotRegParams(ctypes.Structure):
    """``VsrParams``: the registered kernel's slot form's parameters, the
    slot kernel's and a registered form's constants by value."""
    _fields_ = [("base", _CParams), ("dyn", _CSlotRule), ("obs", _CSlotRule),
                ("dyn_c", ctypes.c_double * _VGS_MAX_C), ("obs_c", ctypes.c_double * _VGS_MAX_C)]


def _registered_consts(p: VectorFilterParams, c):
    """A registered form's constants into ``c.dyn_c`` / ``c.obs_c``;
    ``ValueError`` where a form has more than the struct holds."""
    for form, into in ((p.dyn_form, c.dyn_c), (p.obs_form, c.obs_c)):
        if form is not None:
            if len(form.consts) > _VGS_MAX_C:
                raise ValueError(f"each of the shaped and slot forms holds up to {_VGS_MAX_C} "
                                 f"constants of a registered form; got {len(form.consts)}")
            into[:len(form.consts)] = form.consts


@functools.lru_cache(maxsize=64)
def _c_registered_slots(p: VectorFilterParams, device: torch.device) -> _CSlotRegParams:
    """The registered slot form's parameter struct: the slot kernel's (both
    rules by value) and the registered forms' constants; ``ValueError`` for
    rules or constants it cannot hold.  Built once for a given ``(p,
    device)``."""
    c = _CSlotRegParams(base=_c_params(p, device), dyn=_c_slot_rule(p.dyn),
                        obs=_c_slot_rule(p.obs))
    _registered_consts(p, c)
    return c


class _CGShapedParams(ctypes.Structure):
    """``VgsParams``: the parameters of the shaped one-thread form."""
    _fields_ = [("base", _CParams), ("dyn", _CShapedBqRule), ("obs", _CShapedBqRule),
                ("dyn_c", ctypes.c_double * _VGS_MAX_C), ("obs_c", ctypes.c_double * _VGS_MAX_C)]


@functools.lru_cache(maxsize=64)
def _c_general_shaped(p: VectorFilterParams, device: torch.device) -> _CGShapedParams:
    """The shaped one-thread form's parameter struct: :func:`_c_params` (R by
    value) and both rules by value, and a registered form's constants;
    ``ValueError`` for rules or constants it cannot hold.  Built once for a
    given ``(p, device)``."""
    c = _CGShapedParams(base=_c_params(p, device), dyn=_c_shaped_bq_rule(p.dyn),
                        obs=_c_shaped_bq_rule(p.obs))
    _registered_consts(p, c)
    return c


def _c_struct(kernel: str, params: VectorFilterParams, device: torch.device, lanes: int = 0):
    """The parameter struct of ``kernel`` (in the form of ``lanes``, for the
    general and registered kernels) for ``params`` on ``device``;
    ``ValueError`` for a rule that the shaped structs cannot hold."""
    if kernel == "vector_filter_shaped":
        return _c_shaped_params(params, device)
    if kernel == "vector_filter_shaped_bq":
        return _c_shaped_bq_params(params, device)
    if kernel == "vector_filter_slots":
        return _c_slot_params(params, device)
    if kernel == "vector_filter_registered" and lanes == _SLOTS:
        return _c_registered_slots(params, device)
    if kernel in ("vector_filter_general", "vector_filter_registered"):
        return (_c_general_shaped if lanes == _SHAPED else _c_general)(params, device)
    return _c_params(params, device)


_STREAMS = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2)


def _bind(lib: ctypes.CDLL):
    """Declare the argument types of the library's entry points."""
    lib.vf_launch.restype = ctypes.c_int
    lib.vf_launch.argtypes = ([ctypes.POINTER(_CParams)] + _STREAMS + [ctypes.c_int]
                              + [ctypes.c_void_p] * 7)
    lib.vf_error_string.restype = ctypes.c_char_p
    lib.vf_error_string.argtypes = [ctypes.c_int]
    lib.vfs_launch.restype = ctypes.c_int
    lib.vfs_launch.argtypes = ([ctypes.POINTER(_CShapedParams)] + _STREAMS + [ctypes.c_int]
                               + [ctypes.c_void_p] * 6)
    lib.vfs_bq_launch.restype = ctypes.c_int
    lib.vfs_bq_launch.argtypes = ([ctypes.POINTER(_CShapedBqParams)] + _STREAMS + [ctypes.c_int]
                                  + [ctypes.c_void_p] * 6)
    lib.vfg_launch.restype = ctypes.c_int
    lib.vfg_launch.argtypes = ([ctypes.POINTER(_CGParams)] + lib.vf_launch.argtypes[1:-1]
                               + [ctypes.c_int, ctypes.c_void_p])
    lib.vgs_launch.restype = ctypes.c_int
    lib.vgs_launch.argtypes = ([ctypes.POINTER(_CGShapedParams)] + _STREAMS + [ctypes.c_int]
                               + [ctypes.c_void_p] * 6)
    lib.vsl_launch.restype = ctypes.c_int
    lib.vsl_launch.argtypes = ([ctypes.POINTER(_CSlotParams)] + _STREAMS + [ctypes.c_int]
                               + [ctypes.c_void_p] * 6)


#: the sources of the library: the first-version kernel, the classical shaped
#: kernel, the kernel of the BQ shapes, the general kernel and its shaped
#: one-thread form (one count on both rules, then the mixed counts), the BQ
#: shapes' mixed counts, the general kernel's shaped form at the
#: Gauss-Hermite counts, the general kernel's pairs in the slot kernel (2-D
#: and 3-D states, then 4-D and 5-D), and the slot kernel
SOURCES = ["vector_filter.cu", "vector_filter_shaped.cu", "vector_filter_shaped_bq.cu",
           "vector_filter_general.cu", "vector_filter_general_shaped.cu",
           "vector_filter_general_shaped_mixed.cu", "vector_filter_shaped_bq_mixed.cu",
           "vector_filter_general_shaped_gh.cu", "vector_filter_general_slots.cu",
           "vector_filter_general_slots_hi.cu", "vector_filter_slots.cu"]


def build() -> ctypes.CDLL:
    """Compile the eleven sources of :data:`SOURCES` for sm_90a with nvcc
    (once, a compiler each, at once, into one library) and bind it; later
    calls return the bound library."""
    return _build.bound("vector_filter", SOURCES, _bind, _NVCC_FLAGS)


def _bind_host(lib: ctypes.CDLL):
    lib.vf_host_run.restype = ctypes.c_int
    lib.vf_host_run.argtypes = [ctypes.POINTER(_CParams)] + _STREAMS + [ctypes.c_void_p] * 6
    lib.vfs_bq_host_run.restype = ctypes.c_int
    lib.vfs_bq_host_run.argtypes = ([ctypes.POINTER(_CShapedBqParams)] + _STREAMS
                                    + [ctypes.c_void_p] * 5)
    lib.vfg_host_run.restype = ctypes.c_int
    lib.vfg_host_run.argtypes = ([ctypes.POINTER(_CGParams)] + lib.vf_host_run.argtypes[1:]
                                 + [ctypes.c_int])


def _host_shim() -> ctypes.CDLL:
    """The step header built for the host with g++ (tests only)."""
    return _build.bound("vector_filter_host", ["vector_filter_host.cpp"], _bind_host,
                        host=True)


def _bind_shaped_host(lib: ctypes.CDLL):
    lib.vfs_host_run.restype = ctypes.c_int
    lib.vfs_host_run.argtypes = [ctypes.POINTER(_CShapedParams)] + _STREAMS + [ctypes.c_void_p] * 5


def _shaped_host() -> ctypes.CDLL:
    """The classical shaped kernel's step built for the host with g++ (tests
    only; a library of its own, ``vfs_host_run``)."""
    return _build.bound("vector_filter_shaped_host", ["vector_filter_shaped_host.cpp"],
                        _bind_shaped_host, host=True)


def _bind_shaped_bq_host(lib: ctypes.CDLL):
    lib.vfs_bq_mixed_host_run.restype = ctypes.c_int
    lib.vfs_bq_mixed_host_run.argtypes = ([ctypes.POINTER(_CShapedBqParams)] + _STREAMS
                                          + [ctypes.c_void_p] * 5)


def _shaped_bq_host() -> ctypes.CDLL:
    """The BQ shapes' step at mixed point counts built for the host with g++
    (tests only; a library of its own, ``vfs_bq_mixed_host_run``)."""
    return _build.bound("vector_filter_shaped_bq_host", ["vector_filter_shaped_bq_host.cpp"],
                        _bind_shaped_bq_host, host=True)


def _bind_general_shaped_host(lib: ctypes.CDLL):
    lib.vgs_host_run.restype = ctypes.c_int
    lib.vgs_host_run.argtypes = ([ctypes.POINTER(_CGShapedParams)] + _STREAMS
                                 + [ctypes.c_void_p] * 5)


def _general_shaped_host() -> ctypes.CDLL:
    """The general kernel's shaped one-thread form built for the host with
    g++ (tests only; a library of its own, ``vgs_host_run``)."""
    return _build.bound("vector_filter_general_shaped_host",
                        ["vector_filter_general_shaped_host.cpp"], _bind_general_shaped_host,
                        host=True)


def _bind_slots_host(lib: ctypes.CDLL):
    lib.vsl_host_run.restype = ctypes.c_int
    lib.vsl_host_run.argtypes = [ctypes.POINTER(_CSlotParams)] + _STREAMS + [ctypes.c_void_p] * 5


def _slots_host() -> ctypes.CDLL:
    """The slot kernel's step built for the host with g++, its lanes
    collapsed to one (tests only; a library of its own, ``vsl_host_run``)."""
    return _build.bound("vector_filter_slots_host", ["vector_filter_slots_host.cpp"],
                        _bind_slots_host, host=True)


def _bind_general_slots_host(lib: ctypes.CDLL):
    lib.vsg_host_run.restype = ctypes.c_int
    lib.vsg_host_run.argtypes = [ctypes.POINTER(_CSlotParams)] + _STREAMS + [ctypes.c_void_p] * 5


def _general_slots_host() -> ctypes.CDLL:
    """The general kernel's pairs in the slot kernel (``VSL_GENERAL``) built
    for the host with g++, the lanes collapsed to one (tests only; a library
    of its own, ``vsg_host_run``)."""
    return _build.bound("vector_filter_general_slots_host",
                        ["vector_filter_general_slots_host.cpp"], _bind_general_slots_host,
                        host=True)


def _bind_fit(lib: ctypes.CDLL):
    lib.vfl_fit_on.restype = None
    lib.vfl_fit_on.argtypes = [ctypes.POINTER(_CParams), ctypes.c_int, ctypes.c_void_p]
    lib.vgs_takes_on.restype = ctypes.c_int
    lib.vgs_takes_on.argtypes = [ctypes.POINTER(_CParams)]
    lib.vsl_lanes_on.restype = ctypes.c_int
    lib.vsl_lanes_on.argtypes = [ctypes.POINTER(_CParams)]
    lib.vsr_design_on.restype = None
    lib.vsr_design_on.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _fit() -> ctypes.CDLL:
    """``csrc/vector_filter_fit.cpp`` built with g++ (no step in it, a second
    or two): ``vfl_fit_on``, how a configuration runs in the lane-group or
    warp form (:func:`_form_fit`), ``vgs_takes_on``, whether the general
    kernel's shaped form has an instantiation of it (:func:`_shaped_takes`),
    ``vsl_lanes_on``, the slot kernel's lanes for it (:func:`slot_lanes`),
    and ``vsr_design_on``, the registered slot form's design
    (:func:`_slot_design`)."""
    return _build.bound("vector_filter_fit", ["vector_filter_fit.cpp"], _bind_fit, host=True)


# ---------------------------------------------------------------------------
# the registered kernel: a library generated from the registered forms
# ---------------------------------------------------------------------------

#: the configurations of the registered libraries built in this process:
#: ``(host, key)`` -> (library, index in its ``VFR_PAIRS``); a key names the
#: form too (:func:`_key`)
_REGISTERED: dict = {}
#: the arguments of ``vfr_launch`` / ``vfr_host_run`` from ``y`` on
_R_ARGS = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 3)


def _bound_of(E: int) -> int:
    """``vfg_bound``: the bound EB on E of the step that runs E outputs, 0
    (the wide form) above 8."""
    return 2 if E <= 2 else 4 if E <= 4 else 8 if E <= 8 else 0


#: the C math library's functions whose calls :func:`_form_cost` counts
_COSTLY = re.compile(r"\b(?:sqrt|cbrt|exp|expm1|exp2|log|log1p|log2|log10|sin|cos|tan|asin|acos"
                     r"|atan|atan2|sinh|cosh|tanh|pow|hypot|erf|erfc|fmod)\s*\(")


def _form_cost(form: KernelForm) -> int:
    """The transcendental calls and divisions of one evaluation of a
    registered form's statements: the cost by which the shaped form decides
    whether its point loops unroll (``vgs_roll``)."""
    return len(_COSTLY.findall(form.source)) + form.source.count("/")


def _model_policy(params: VectorFilterParams, name: str, EB: int, shaped: bool = False,
                  slots: tuple | None = None) -> str:
    """The C++ model policy of ``params``' configuration (see
    ``csrc/vector_filter_registered.cu``): each registered form's statements
    as a functor, the table's models through ``VfgDynFn`` / ``VfgObsFn`` (a
    table measurement at the bound ``EB`` on E, 0 for any E).  ``shaped``:
    the policy of the shaped one-thread form (``VFR_SHAPED``), on
    ``VgsParams``: the constants by value, the table's models by their ids
    (``VfDynFn`` / ``VgsObsFn``), and the rules' point counts and kinds and
    the models' costs as its constants.  ``slots``: the design ``(G, split,
    keep)`` of the slot form (``VFR_SLOTS``), whose policy is the shaped
    one's on any parameters with ``base``, ``dyn_c`` and ``obs_c`` (a lane's
    view of ``VsrParams``), stating N, the design and whether each model is
    costly (``vgs_rolled`` of its cost)."""
    D, E = params.dim_state, params.dim_out
    shaped = shaped or slots is not None
    P = "P" if slots else "VgsParams" if shaped else "VfgParams"
    on = "template <class P>\n  " if slots else ""
    head = ""
    if shaped:
        dyn_cost = (f"vgs_dyn_cost({params.dyn_model})" if params.dyn_form is None
                    else _form_cost(params.dyn_form))
        obs_cost = (f"vgs_obs_cost({params.obs_model}, {E})" if params.obs_form is None
                    else _form_cost(params.obs_form))
        head = (f"  static constexpr int N = {params.dyn.n}, G = {slots[0]};\n"
                f"  static constexpr bool split = {str(slots[1]).lower()}, "
                f"keep = {str(slots[2]).lower()};\n" if slots else
                f"  static constexpr int ND = {params.dyn.n}, NO = {params.obs.n}, "
                f"KD = {params.dyn.kind}, KO = {params.obs.kind};\n")
        head += (f"  static constexpr int dyn_cost = {dyn_cost}, "
                 f"obs_cost = {obs_cost};\n")
        if slots:
            head += ("  static constexpr bool dyn_rolled = vgs_rolled(dyn_cost), "
                     "obs_rolled = vgs_rolled(obs_cost);\n")
    if params.dyn_form is None:
        dyn = (f"  {on}VF_HD static VfDynFn<{D}, {params.dyn_model}> dyn(const {P}& p, "
               "const double*) { return {p.base}; }" if shaped else
               f"  VF_HD static VfgDynFn<{D}> dyn(const {P}& p, const double*) "
               "{ return {p.base}; }")
    else:
        dyn = (f"  struct Dyn {{\n    const double* c;\n    const double* s;\n"
               f"    VF_HD void operator()(const double (&x)[{D}], double (&f)[{D}]) const {{\n"
               f"{forms.c_block(params.dyn_form.source)}\n    }}\n  }};\n"
               f"  {on}VF_HD static Dyn dyn(const {P}& p, const double* s) "
               "{ return {p.dyn_c, s}; }")
    if params.obs_form is None:
        obs = (f"  {on}VF_HD static VgsObsFn<{D}, {params.obs_model}, {E}> obs(const {P}& p) "
               "{ return {p.base}; }" if shaped else
               f"  VF_HD static VfgObsFn<{D}, {EB}> obs(const {P}& p) {{ return {{p}}; }}")
    else:
        arg, gather = "x", ""
        if params.obs_index is not None:
            arg, gather = "x_state", f"    const double x[1] = {{x_state[{params.obs_index}]}};\n"
        obs = (f"  struct Obs {{\n    const double* c;\n    template <class H>\n"
               f"    VF_HD void operator()(const double (&{arg})[{D}], H&& h) const {{\n"
               f"{gather}{forms.c_block(params.obs_form.source)}\n    }}\n  }};\n"
               f"  {on}VF_HD static Obs obs(const {P}& p) {{ return {{p.obs_c}}; }}")
    return f"struct {name} {{\n{head}{dyn}\n{obs}\n}};\n"


def _key(params: VectorFilterParams, lanes: int | None = None) -> tuple:
    """What the registered library instantiates for ``params`` in the form of
    ``lanes`` (:func:`lanes_of` by default; 0 one thread a trajectory,
    :data:`_SHAPED` the shaped one-thread form, :data:`_SLOTS` the slot form,
    :data:`_LANES` the lane-group form, :data:`_WARP` the warp form): D, the
    bound on E (0 in the lane-group and warp forms; E itself in the shaped
    and slot forms), the lanes and the model policy."""
    lanes = lanes_of(params) if lanes is None else lanes
    if lanes == _SHAPED:
        E = params.dim_out
        return params.dim_state, E, lanes, _model_policy(params, "VfrPair", E, shaped=True)
    if lanes == _SLOTS:
        E, design = params.dim_out, _slot_design(params)
        if not design[0]:
            raise ValueError("the registered kernel's slot form does not take this "
                             "configuration (slot_lanes)")
        return params.dim_state, E, lanes, _model_policy(params, "VfrPair", E, slots=design)
    EB = 0 if lanes else _bound_of(params.dim_out)
    return params.dim_state, EB, lanes, _model_policy(params, "VfrPair", EB)


def _registered_header(keys: list) -> str:
    """``vfr_forms.cuh`` for the configurations ``keys``: ``VFR_PAIRS``
    lists those of the general step's forms, ``VFR_SHAPED`` those of the
    shaped one-thread form, ``VFR_SLOTS`` those of the slot form."""
    parts = ["// Generated by ssmtoybox_torch/ops/vector_filter.py (build_registered): the",
             "// model policies of the registered configurations.", "#pragma once", ""]
    for i, (_, _, _, policy) in enumerate(keys):
        parts.append(policy.replace("struct VfrPair {", f"struct VfrPair{i} {{", 1))
    pairs = " ".join(f"F({i}, {D}, {EB}, {G}, VfrPair{i})"
                     for i, (D, EB, G, _) in enumerate(keys) if G not in (_SHAPED, _SLOTS))
    shaped, slots = (" ".join(f"F({i}, {D}, {E}, VfrPair{i})"
                              for i, (D, E, G, _) in enumerate(keys) if G == form)
                     for form in (_SHAPED, _SLOTS))
    return ("\n".join(parts) + f"\n#define VFR_PAIRS(F) {pairs}\n"
            f"#define VFR_SHAPED(F) {shaped}\n#define VFR_SLOTS(F) {slots}\n")


def _bind_registered(lib: ctypes.CDLL):
    lib.vfr_launch.restype = ctypes.c_int
    lib.vfr_launch.argtypes = ([ctypes.c_int, ctypes.POINTER(_CGParams)] + _R_ARGS
                               + [ctypes.c_int] + [ctypes.c_void_p] * 7)
    lib.vfr_shaped_launch.restype = ctypes.c_int
    lib.vfr_shaped_launch.argtypes = ([ctypes.c_int, ctypes.POINTER(_CGShapedParams)] + _R_ARGS
                                      + [ctypes.c_int] + [ctypes.c_void_p] * 6)
    lib.vfr_slots_launch.restype = ctypes.c_int
    lib.vfr_slots_launch.argtypes = ([ctypes.c_int, ctypes.POINTER(_CSlotRegParams)] + _R_ARGS
                                     + [ctypes.c_int] + [ctypes.c_void_p] * 6)
    lib.vfr_error_string.restype = ctypes.c_char_p
    lib.vfr_error_string.argtypes = [ctypes.c_int]


def _bind_registered_host(lib: ctypes.CDLL):
    lib.vfr_host_run.restype = ctypes.c_int
    lib.vfr_host_run.argtypes = ([ctypes.c_int, ctypes.POINTER(_CGParams)] + _R_ARGS
                                 + [ctypes.c_void_p] * 6)
    lib.vfr_shaped_host_run.restype = ctypes.c_int
    lib.vfr_shaped_host_run.argtypes = ([ctypes.c_int, ctypes.POINTER(_CGShapedParams)] + _R_ARGS
                                        + [ctypes.c_void_p] * 5)


def _bind_registered_slots_host(lib: ctypes.CDLL):
    lib.vfr_slots_host_run.restype = ctypes.c_int
    lib.vfr_slots_host_run.argtypes = ([ctypes.c_int, ctypes.POINTER(_CSlotRegParams)] + _R_ARGS
                                       + [ctypes.c_void_p] * 5)


def build_registered(configs, host: bool = False) -> str:
    """Build one library of the registered kernel for the configurations
    ``configs`` (:class:`VectorFilterParams` with a registered model, each in
    the form of :func:`lanes_of`, or ``(params, lanes)`` in the form of
    ``lanes``) with nvcc for sm_90a (with g++, if ``host``, the host builds
    ``vfr_host_run`` of ``csrc/vector_filter_host.cpp`` and, for the slot
    form's configurations, a library of their own,
    ``vfr_slots_host_run`` of ``csrc/vector_filter_general_slots_host.cpp``): a
    header of their model policies is generated, only their instantiations
    are compiled, and their launches go to it from then on.  A
    configuration's first launch builds a library for it alone if none
    holds it.  Returns the library's name (its compiler output is
    ``_build.BUILD_LOGS[name]``); a failed build raises ``RuntimeError``
    with the compiler's output."""
    pairs = [c if isinstance(c, tuple) else (c, None) for c in configs]
    keys = list(dict.fromkeys(_key(p, lanes) for p, lanes in pairs if _registered_pair(p)))
    if not keys:
        raise ValueError("no configuration with a registered model to build")
    if host:
        slot_keys = [k for k in keys if k[2] == _SLOTS]
        keys = [k for k in keys if k[2] != _SLOTS]
        if slot_keys:
            name = forms.build_generated(
                _REGISTERED, slot_keys, _registered_header(slot_keys),
                name="vector_filter_registered_slots_host",
                source="vector_filter_general_slots_host.cpp", file="vfr_forms.cuh",
                bind=_bind_registered_slots_host, flags=["-DVFR_REGISTERED"], host=True)
            if not keys:
                return name
        return forms.build_generated(
            _REGISTERED, keys, _registered_header(keys), name="vector_filter_registered_host",
            source="vector_filter_host.cpp", file="vfr_forms.cuh", bind=_bind_registered_host,
            flags=["-DVFR_REGISTERED"], host=True)
    return forms.build_generated(
        _REGISTERED, keys, _registered_header(keys), name="vector_filter_registered",
        source="vector_filter_registered.cu", file="vfr_forms.cuh", bind=_bind_registered,
        flags=_NVCC_FLAGS, host=False)


def _registered(params: VectorFilterParams, host: bool, lanes: int | None = None) -> tuple:
    """(library, index) of ``params``' configuration in the form of ``lanes``
    (:func:`lanes_of` by default), built at first use."""
    key = _key(params, lanes)
    if (host, key) not in _REGISTERED:
        build_registered([(params, lanes)], host)
    return _REGISTERED[host, key]


def _check_streams(params: VectorFilterParams, y: torch.Tensor):
    if y.dtype != torch.float64:
        raise TypeError(f"the vector filter runs in float64; got {y.dtype}")
    if y.ndim != 3 or y.shape[1] != params.dim_out:
        raise ValueError(f"y must be (B, {params.dim_out}, T); got {tuple(y.shape)}")
    if y.shape[0] >= 2 ** 31 or y.shape[2] >= 2 ** 31:
        raise ValueError(f"at most 2**31 - 1 trajectories and steps; got {tuple(y.shape)}")


def _scratch(params: VectorFilterParams, B: int, device, lanes: int = 0) -> torch.Tensor:
    """The one-thread forms' scratch buffer: the function values of every
    point of a transform, interleaved by trajectory, and for more than 8
    measurement outputs the wide form's E-sized arrays after them
    (``vfg_values`` and ``vfg_step_wide``); empty for the other forms
    (``lanes`` nonzero): the shaped form keeps its values on chip, the
    lane-group and warp forms theirs in shared memory."""
    D, E = params.dim_state, params.dim_out
    n = max(params.dyn.n * D, params.obs.n * E)
    if _bound_of(E) == 0:
        n += 2 * E + 2 * E * E + 4 * D * E
    return torch.empty(0 if lanes else n * B, dtype=torch.float64, device=device)


def _host_shim_run(params: VectorFilterParams, y: torch.Tensor, kernel: str | None = None,
                   lanes: int | None = None):
    """Run the step of ``kernel`` (``"vector_filter"``,
    ``"vector_filter_shaped"``, ``"vector_filter_shaped_bq"``,
    ``"vector_filter_slots"`` (its lanes collapsed to one),
    ``"vector_filter_general"`` or ``"vector_filter_registered"``; by default
    the first version where it has an instantiation of the model pair, the
    registered kernel for a registered model, else the general kernel)
    compiled for the host on a CPU tensor, the general and registered
    kernels in the form of ``lanes`` (:func:`lanes_of` by default; the
    classical shaped kernel, the BQ shapes' mixed counts, the slot kernel (the
    general kernel's pairs in it too) and the general kernel's shaped form
    through host builds of their own, :func:`_shaped_host`,
    :func:`_shaped_bq_host`, :func:`_slots_host`, :func:`_general_slots_host`
    and :func:`_general_shaped_host`; the registered slot form through its
    library's, :func:`build_registered`); the five
    streams of :func:`vector_filter`, after checking that an instantiation
    of the configuration's dimensions ran."""
    _check_streams(params, y)
    if y.device.type != "cpu":
        raise ValueError(f"the host build takes CPU tensors; got {y.device}")
    if kernel is None:
        kernel = ("vector_filter_registered" if _registered_pair(params) else
                  "vector_filter" if _instantiated(params) else "vector_filter_general")
    B, _, T = y.shape
    out = _empty_streams(params.dim_state, T, B, "cpu")
    cpu = torch.device("cpu")
    lanes = lanes_of(params) if lanes is None else lanes
    c = _c_struct(kernel, params, cpu, lanes)              # refuses before anything is built
    if kernel == "vector_filter_registered":
        lib, pair = _registered(params, host=True, lanes=lanes)
        s, scratch = _streams_on(params, T, cpu), _scratch(params, B, cpu, lanes)
        if lanes in (_SHAPED, _SLOTS):
            run = lib.vfr_shaped_host_run if lanes == _SHAPED else lib.vfr_slots_host_run
            ran = run(pair, ctypes.byref(c), y.data_ptr(), *y.stride(), s.data_ptr(), params.n_s,
                      B, T, *(o.data_ptr() for o in out))
        else:
            ran = lib.vfr_host_run(pair, ctypes.byref(c), y.data_ptr(), *y.stride(),
                                   s.data_ptr(), params.n_s, B, T, *(o.data_ptr() for o in out),
                                   scratch.data_ptr())
    elif kernel == "vector_filter_general" and lanes == _SHAPED:
        ran = _general_shaped_host().vgs_host_run(ctypes.byref(c), y.data_ptr(), *y.stride(), B,
                                                  T, *(o.data_ptr() for o in out))
    elif kernel == "vector_filter_shaped":
        ran = _shaped_host().vfs_host_run(ctypes.byref(c), y.data_ptr(), *y.stride(), B, T,
                                          *(o.data_ptr() for o in out))
    elif kernel == "vector_filter_slots":
        run = (_slots_host().vsl_host_run if _instantiated(params) else
               _general_slots_host().vsg_host_run)
        ran = run(ctypes.byref(c), y.data_ptr(), *y.stride(), B, T, *(o.data_ptr() for o in out))
    elif kernel == "vector_filter_shaped_bq":
        run = (_host_shim().vfs_bq_host_run if params.dyn.n == params.obs.n else
               _shaped_bq_host().vfs_bq_mixed_host_run)
        ran = run(ctypes.byref(c), y.data_ptr(), *y.stride(), B, T, *(o.data_ptr() for o in out))
    elif kernel == "vector_filter_general":
        scratch = _scratch(params, B, cpu, lanes)
        ran = _host_shim().vfg_host_run(ctypes.byref(c), y.data_ptr(), *y.stride(), B, T,
                                        *(o.data_ptr() for o in out), scratch.data_ptr(), lanes)
    else:
        scratch = _scratch(params, B, cpu)
        ran = _host_shim().vf_host_run(ctypes.byref(c), y.data_ptr(), *y.stride(), B, T,
                                       *(o.data_ptr() for o in out), scratch.data_ptr())
    if ran != params.dim_state:
        raise RuntimeError(f"the host build ran the D={ran} step for D={params.dim_state}")
    return out


def vector_filter(params: VectorFilterParams, y: torch.Tensor):
    """Filter B records of a vector state in one kernel launch.

    ``y`` (B, E, T) float64 measurements, any strides (the kernel reads it
    through them, no copy is made).  Returns the five time-major streams
    ``(m_fi, P_fi, m_pr, P_pr, xx)``: filtered mean (T, D, B) and covariance
    (T, D, D, B), predicted mean and covariance, and the dynamics
    transform's cross-covariance (T, D, D, B).  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel of :func:`kernel_of` on the
    current stream, without synchronising, or raises.
    """
    global LAUNCHES, SHAPED_LAUNCHES, BQ_SHAPED_LAUNCHES, SLOT_LAUNCHES, GENERAL_LAUNCHES
    global REGISTERED_LAUNCHES
    global GENERAL_LANE_LAUNCHES, REGISTERED_LANE_LAUNCHES, GENERAL_WARP_LAUNCHES
    global REGISTERED_WARP_LAUNCHES, GENERAL_SHAPED_LAUNCHES, REGISTERED_SHAPED_LAUNCHES
    global REGISTERED_SLOT_LAUNCHES
    _check_streams(params, y)
    if y.device.type == "cpu":
        return _vector_filter_plain(params, y)
    if y.device.type != "cuda":
        raise ValueError(f"the vector filter runs on CPU or CUDA tensors; got {y.device}")
    kernel, lanes = kernel_of(params), lanes_of(params)
    c = _c_struct(kernel, params, y.device, lanes)        # refuses before anything is built
    registered = kernel == "vector_filter_registered"
    lib, pair = _registered(params, host=False) if registered else (build(), None)
    B, _, T = y.shape
    out = _empty_streams(params.dim_state, T, B, y.device)
    if y.numel() == 0:
        return out
    args = (ctypes.byref(c), y.data_ptr(), *y.stride(), B, T, y.device.index or 0,
            *(o.data_ptr() for o in out))
    stream = torch.cuda.current_stream(y.device).cuda_stream
    if registered and lanes in (_SHAPED, _SLOTS):
        s = _streams_on(params, T, y.device)
        run = lib.vfr_shaped_launch if lanes == _SHAPED else lib.vfr_slots_launch
        rc = run(pair, ctypes.byref(c), y.data_ptr(), *y.stride(), s.data_ptr(), params.n_s, B, T,
                 y.device.index or 0, *(o.data_ptr() for o in out), stream)
    elif registered:
        s, scratch = _streams_on(params, T, y.device), _scratch(params, B, y.device, lanes)
        rc = lib.vfr_launch(pair, ctypes.byref(c), y.data_ptr(), *y.stride(), s.data_ptr(),
                            params.n_s, B, T, y.device.index or 0, *(o.data_ptr() for o in out),
                            scratch.data_ptr(), stream)
    elif kernel == "vector_filter_general" and lanes == _SHAPED:
        rc = lib.vgs_launch(*args, stream)
    elif kernel == "vector_filter_shaped":
        rc = lib.vfs_launch(*args, stream)
    elif kernel == "vector_filter_shaped_bq":
        rc = lib.vfs_bq_launch(*args, stream)
    elif kernel == "vector_filter_slots":
        rc = lib.vsl_launch(*args, stream)
    elif kernel == "vector_filter_general":
        scratch = _scratch(params, B, y.device, lanes)
        rc = lib.vfg_launch(*args, scratch.data_ptr(), lanes, stream)
    else:
        scratch = _scratch(params, B, y.device)
        rc = lib.vf_launch(*args, scratch.data_ptr(), stream)
    if rc != 0:
        text = (lib.vfr_error_string if registered else lib.vf_error_string)(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {text} (cudaError {rc})")
    LAUNCHES += 1
    SHAPED_LAUNCHES += int(kernel == "vector_filter_shaped")
    BQ_SHAPED_LAUNCHES += int(kernel == "vector_filter_shaped_bq")
    SLOT_LAUNCHES += int(kernel == "vector_filter_slots")
    GENERAL_LAUNCHES += int(kernel == "vector_filter_general")
    REGISTERED_LAUNCHES += int(registered)
    GENERAL_LANE_LAUNCHES += int(kernel == "vector_filter_general" and lanes == _LANES)
    REGISTERED_LANE_LAUNCHES += int(registered and lanes == _LANES)
    GENERAL_WARP_LAUNCHES += int(kernel == "vector_filter_general" and lanes == _WARP)
    REGISTERED_WARP_LAUNCHES += int(registered and lanes == _WARP)
    GENERAL_SHAPED_LAUNCHES += int(kernel == "vector_filter_general" and lanes == _SHAPED)
    REGISTERED_SHAPED_LAUNCHES += int(registered and lanes == _SHAPED)
    REGISTERED_SLOT_LAUNCHES += int(registered and lanes == _SLOTS)
    return out


# ---------------------------------------------------------------------------
# the chain floor of the kernel (measurement helpers)
# ---------------------------------------------------------------------------

def chain_floor_clocks(lat: dict, params: VectorFilterParams) -> float:
    """Clocks of the critical path of one filter step with every independent
    operation overlapped: what one thread a trajectory cannot go below.
    ``lat``: ``scalar_filter.dependent_latencies`` of the card.

    Per D x D Cholesky, D square roots and D - 1 divides, each column waiting
    on the one before, with ~2 (D - 1) adds and multiplies to each diagonal;
    per transform one point (``D`` adds after a multiply for ``L xi``, one for
    ``m +``), the model (:data:`_DYN_CHAIN`, :data:`_OBS_CHAIN`), the mean
    (``n`` adds) and the moments (classical: 3 to the first term and ``n``
    adds; BQ: the row sum, ``n`` adds, then ``n`` adds of the quadratic form
    and 2); the noise terms (2), the E x E Cholesky, the gain (2 E divides, 2
    E adds) and the update (E + 3 adds and multiplies)."""
    plain = 0.5 * (lat["add"] + lat["mul"])
    D, E = params.dim_state, params.dim_out

    def chol(n):
        return n * lat["sqrt"] + (n - 1) * lat["div"] + 2 * (n - 1) * plain

    def moments(rule):
        return (rule.n + (3 + rule.n if rule.kind == 0 else 2 * rule.n + 2)) * plain

    def model(chain):
        return sum((plain if op == "plain" else lat[op]) * k for op, k in chain.items())

    point = (D + 2) * plain
    return (chol(D) + point + model(_DYN_CHAIN[params.dyn_model]) + moments(params.dyn) + plain
            + chol(D) + point + model(_OBS_CHAIN[params.obs_model]) + moments(params.obs)
            + plain + chol(E) + 2 * E * (lat["div"] + plain) + (E + 3) * plain)


#: the longest chain of dependent operations through each model's function,
#: by model id: reentry, a square root, a divide and an exp between 11 adds
#: and multiplies; CV, 2; the pendulum, a sine and 2; the falling body, an exp
#: and 4; the coordinated turn, a sine, a divide and 4; the radar, 3 and the
#: longer of its square root and atan2 (the atan2); the sine measurement, a
#: sine; the range, a square root and 3; the bearings, an atan2 and 1; the
#: UNGM measurement, 2
_DYN_CHAIN = {0: {"sqrt": 1, "div": 1, "exp": 1, "plain": 11}, 1: {"plain": 2},
              2: {"sin": 1, "plain": 2}, 3: {"exp": 1, "plain": 4},
              4: {"sin": 1, "div": 1, "plain": 4}}
_OBS_CHAIN = {0: {"atan2": 1, "plain": 3}, 1: {"sin": 1}, 2: {"sqrt": 1, "plain": 3},
              3: {"atan2": 1, "plain": 1}, 4: {"plain": 2}}
