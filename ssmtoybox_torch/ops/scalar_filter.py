"""Fused whole-record scalar sigma-point filter: CUDA kernel, launcher, plain twin.

Counterpart of the JAX package's ``ops/ddfilter.py`` with its Pallas kernel
``ops/ddscan_pallas.py::pallas_scalar_filter``.  On a TPU that kernel exists
to beat the per-step dispatch floor of ``lax.scan``; an eager PyTorch filter
on the card has the same floor (about 70 small device operations a step), so the
port runs the whole record of every trajectory inside one launch of a CUDA
kernel (``csrc/scalar_filter.cu``) in native float64 (the card needs no
double-double arithmetic).  The kernel has two forms (:func:`form_of`):

- ``"shaped"``: the UNGM measurement and rules of at most ``MAX_PTS`` points.
  The kernel is bound by the dependency chain of one trajectory, so the
  rule's shape is a template argument (the kinds of both rules and 3, 5, 7
  or 8 slots) and a trajectory is spread over a few lanes of a warp, one or
  two sigma points a lane.  The main path's UNGM lanes run here.
- ``"general"``: everything else the lowering admits of the kernel's own
  models, rules of any point count (Gauss-Hermite of degree 9 and up, GPQ
  and BSQ on those points) and the sine and range measurements.
- ``"registered"``: the general form's designs on models registered at run
  time (:func:`register_dyn_dd`, :func:`register_obs_dd`, and 1-D forms of
  ``vector_filter.register_dyn_dd_vec`` / ``register_obs_dd_vec``), as the
  JAX package's Pallas kernel takes the step of whatever model is registered
  (``ops/ddfilter.py:222-253``): ``csrc/scalar_filter_registered.cu``,
  built at first use from a header generated from their
  :class:`~.forms.KernelForm` s (:func:`build_registered`), the transition's
  per-step streams in place of the UNGM constants.

The general and registered forms have two designs (:func:`geometry`): up to
:data:`MAX_SLOTS` points the slot design (``csrc/scalar_filter_slots.cuh``,
``sfs_record`` in ``csrc/scalar_filter_step_general.cuh``): the shaped
form's step at one of :data:`SLOTS` slots on a few lanes a trajectory, the
models as a policy's functors (the kernel's own, or the registered forms'
statements), the rules' vectors by value (:func:`_c_slot_rules`) and a BQ
rule's dense weights staged in shared memory once a block, no scratch;
above it one thread a trajectory, the point count, kinds and measurement
read at run time, the rules from device memory and the function values
through a scratch buffer.

In all three, every sum runs in the order of the twin, so kernel and twin
agree to the bit.

Supported, as the JAX package's ``ops.ddvec.dd_check`` admits a 1-D state
under the same registrations: a transition with a kernel form (the UNGM
transition, or a registered one) with a measurement with one (the UNGM,
sine (``Pendulum2DMeasurement``) or range (``RangeMeasurement``)
measurement of the state, or a registered one), additive noise, and for
each of the two transforms either a classical 1-D sigma-point rule with
diagonal covariance weights or a 1-D BQ rule with a scalar model variance,
of any point count.  The scalar registry is looked up by exact type, as
``ddfilter`` looks it up: a subclass of a registered class has no form of
its own.  :func:`supports` says whether a configuration qualifies.

:func:`scalar_filter` is the launch wrapper.  For a CPU tensor it runs the
plain PyTorch twin :func:`_scalar_filter_plain`; for a CUDA tensor it launches
the kernel or raises.  Each launch adds one to :data:`LAUNCHES`; a launch of
the general form also to :data:`GENERAL_LAUNCHES`, one of the registered form
to :data:`REGISTERED_LAUNCHES`, one of either in the slot design to
:data:`SLOT_LAUNCHES`.

Nothing is built, lowered or copied per call: the library is bound once a
process, a transform's :class:`Rule` and a model's noise constants are kept
on the object they were read from (and read again if its tensors were
replaced), the parameter struct is cached by :class:`ScalarFilterParams` and
the UNGM constants by length and device.  A transform's or a model's tensors
are taken as fixed once built: change one through ``replace()`` or a new
object, not in place.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from ..bq.gpqd import GaussianProcessDerTransform
from ..bq.transforms import BQTransform, MultiOutputBQTransform, StudentTProcessTransform
from ..mtran import SigmaPointTransform
from ..ssmod import Pendulum2DMeasurement, RangeMeasurement, UNGMMeasurement
from ..utils.arrays import resolve_device
from . import _build, forms
from .forms import TORCH_FNS, KernelForm, Registered, find_dyn, find_obs

__all__ = ["LAUNCHES", "GENERAL_LAUNCHES", "REGISTERED_LAUNCHES", "SLOT_LAUNCHES", "MAX_PTS",
           "MAX_SLOTS", "form_of", "geometry", "Rule",
           "ScalarFilterParams", "register_dyn_dd", "register_obs_dd", "lower_transform",
           "supports", "prepare", "ungm_consts", "scalar_filter", "scalar_filter_moments",
           "scalar_filter_batch", "build", "build_registered", "slots", "SLOTS",
           "dependent_latencies", "chain_floor_clocks"]

#: kernel launches made by :func:`scalar_filter` in this process, all forms
LAUNCHES = 0
#: the launches of the general form among them
GENERAL_LAUNCHES = 0
#: the launches of the registered form among them
REGISTERED_LAUNCHES = 0
#: the launches of the general and registered forms in the slot design
SLOT_LAUNCHES = 0

#: most sigma points a rule of the shaped form may have (``SF_MAX_PTS`` in the
#: step header): enough for the 7-point Gauss-Hermite and BSQ-GH7 rules; the
#: parameter struct, passed by value, is then 1,600 bytes, under the 4 KB
#: limit of a kernel's parameters.  Larger rules run in the general form
MAX_PTS = 8
#: the slot counts: the shaped form's (3, 5, 7, 8) and the slot design's
#: (all of them, up to ``MAX_SLOTS``, ``SF_MAX_SLOTS`` in the step header); a
#: configuration runs at the smallest that holds both rules, padded with zero
#: weights
SLOTS = (3, 5, 7, 8, 9, 12, 16, 20, 24, 32)
MAX_SLOTS = 32

#: the kernel's own measurements of a 1-D state: class -> (id in
#: ``scalar_filter_step_general.cuh``, constants); the shaped form takes id 0
_OBS_MODELS = {
    UNGMMeasurement: (0, lambda m: ()),
    Pendulum2DMeasurement: (1, lambda m: ()),
    RangeMeasurement: (2, lambda m: (float(m.sx) ** 2, float(m.sy))),
}

#: ``--fmad=false``: no multiply-add contraction, so the kernel rounds after
#: every operation exactly like the twin's separate elementwise ops; with
#: contraction the UNGM map grew the last-bit differences to 3.4e-8 within
#: 20 steps on some of 4096 records (measured on an H100)
_NVCC_FLAGS = ["--fmad=false"]


# ---------------------------------------------------------------------------
# lowering a configuration to kernel constants
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Rule:
    """A 1-D quadrature rule as kernel constants.  ``kind`` 0: classical
    (``wc`` diagonal covariance weights); 1: BQ (dense ``Wc``, cross weights
    ``wcc``, expected model variance ``emv``)."""

    kind: int
    xi: tuple
    wm: tuple
    wc: tuple = ()
    Wc: tuple = ()
    wcc: tuple = ()
    emv: float = 0.0

    @property
    def n(self) -> int:
        return len(self.xi)


@dataclass(frozen=True)
class ScalarFilterParams:
    """Everything the kernel takes besides the data streams."""

    dyn: Rule
    obs: Rule
    m0: float
    P0: float
    gqg: float
    r: float
    #: the measurement's id in ``_OBS_MODELS`` (-1 for a registered form) and
    #: its constants
    obs_model: int = 0
    obs_c: tuple = ()
    #: registered models' forms (None: the kernel's own UNGM transition or
    #: measurement), a registered transition's constants
    dyn_form: KernelForm | None = None
    obs_form: KernelForm | None = None
    dyn_c: tuple = ()
    #: a registered transition's per-step streams, ``streams(n_steps)`` (n_steps,
    #: n_s); the UNGM transition's is :func:`ungm_consts`
    n_s: int = 1
    streams: object = field(default=None, compare=False)
    _on: dict = field(default_factory=dict, compare=False, repr=False)


def register_dyn_dd(model_cls, step_consts, form):
    """Register a 1-D transition model for ``engine="dd"``
    (``ddfilter.register_dyn_dd``): ``step_consts(model, n_steps)`` its
    per-step constant stream, (n_steps,) float64 (step k reads value k as
    ``s[0]``); ``form`` its :class:`~.forms.KernelForm`, or a function of
    the model giving one.  Looked up by exact type; registering a class again
    replaces its entry."""
    forms.DYN_DD[model_cls] = (step_consts, form)


def register_obs_dd(model_cls, form):
    """Register a measurement model of one output (``ddfilter.
    register_obs_dd``): its :class:`~.forms.KernelForm`, which reads the one
    component ``x[0]`` (the state component its ``state_index`` picks, on a
    vector state too), or a function of the model giving one.  Looked up by
    exact type."""
    forms.OBS_DD[model_cls] = form


class _CRule(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("n", ctypes.c_int),
                ("xi", ctypes.c_double * MAX_PTS), ("wm", ctypes.c_double * MAX_PTS),
                ("wc", ctypes.c_double * MAX_PTS),
                ("Wc", ctypes.c_double * (MAX_PTS * MAX_PTS)),
                ("wcc", ctypes.c_double * MAX_PTS), ("emv", ctypes.c_double)]


class _CParams(ctypes.Structure):
    _fields_ = [("dyn", _CRule), ("obs", _CRule), ("m0", ctypes.c_double),
                ("P0", ctypes.c_double), ("gqg", ctypes.c_double), ("r", ctypes.c_double)]


def _c_rule(rule: Rule) -> _CRule:
    c = _CRule(kind=rule.kind, n=rule.n, emv=rule.emv)
    for name in ("xi", "wm", "wc", "wcc"):
        vals = getattr(rule, name)
        getattr(c, name)[:len(vals)] = vals
    for i in range(rule.n if rule.Wc else 0):
        c.Wc[i * MAX_PTS:i * MAX_PTS + rule.n] = rule.Wc[i]
    return c


@functools.lru_cache(maxsize=64)
def _c_params(p: ScalarFilterParams) -> _CParams:
    """The shaped form's parameter struct, zero past each rule's points;
    built once for a given ``p``; ``ValueError`` for a configuration that
    the shaped form does not take."""
    if form_of(p) != "shaped":
        raise ValueError(f"the shaped scalar filter takes the UNGM measurement and rules of at "
                         f"most {MAX_PTS} points; got measurement {p.obs_model}, rules of "
                         f"{p.dyn.n} and {p.obs.n} points")
    return _CParams(dyn=_c_rule(p.dyn), obs=_c_rule(p.obs), m0=p.m0, P0=p.P0,
                    gqg=p.gqg, r=p.r)


def _floats(t) -> tuple:
    return tuple(float(v) for v in np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t,
                                              np.float64).ravel())


def _memo(obj, slot: str, sources: tuple, make):
    """``make()``, kept on ``obj`` for as long as ``sources`` are the very
    objects it was made from, none edited in place since (a tensor's
    ``_version`` counts its in-place edits; a copy of ``obj`` whose tensors
    were replaced carries the entry along but not the sources, and is lowered
    anew).  Inference tensors count no edits, so what is made from one is not
    kept.  A hit reads nothing from the card."""
    tensors = [s for s in sources if isinstance(s, torch.Tensor)]
    if any(t.is_inference() for t in tensors):
        obj.__dict__.pop(slot, None)
        return make()
    stamps = tuple(t._version for t in tensors)
    hit = obj.__dict__.get(slot)
    if hit is not None and hit[1] == stamps and len(hit[0]) == len(sources) and all(
            a is b for a, b in zip(hit[0], sources)):
        return hit[2]
    value = make()
    obj.__dict__[slot] = (sources, stamps, value)
    return value


def lower_transform(tf) -> Rule:
    """The kernel's constants for a 1-D transform; ``ValueError`` if the
    kernel cannot run it.  The weights are read from the transform's device
    once and kept on the transform."""
    if isinstance(tf, SigmaPointTransform):
        sources = (tf.unit_sp, tf.wm, tf.wc_diag)
    elif isinstance(tf, BQTransform):
        sources = (tf.points, tf.wm, tf.Wc, tf.Wcc, tf._emv)
    elif isinstance(tf, MultiOutputBQTransform):
        sources = (tf.points, tf.wm)
    else:
        raise ValueError(f"unsupported transform for the fused scalar filter: {type(tf)!r}")
    return _memo(tf, "_scalar_filter_rule", sources, lambda: _lower(tf))


def _lower(tf) -> Rule:
    if isinstance(tf, SigmaPointTransform):
        if tf.wc_diag is None:
            raise ValueError("the fused scalar filter needs diagonal classical weights")
        if tf.unit_sp.shape[0] != 1:
            raise ValueError("the fused scalar filter needs a 1-D rule")
        rule = Rule(kind=0, xi=_floats(tf.unit_sp), wm=_floats(tf.wm), wc=_floats(tf.wc_diag))
    elif isinstance(tf, StudentTProcessTransform):
        raise ValueError("the fused scalar filter has no data-dependent (TPQ) model variance")
    elif isinstance(tf, GaussianProcessDerTransform):
        raise ValueError("GPQ+D derivative observations have no kernel form in the fused "
                         "scalar filter")
    elif isinstance(tf, MultiOutputBQTransform):
        raise ValueError(f"multi-output BQ transforms ({type(tf).__name__}) have per-output "
                         "weight tensors with no kernel form in the fused scalar filter")
    elif isinstance(tf, BQTransform):
        if tf.points.shape[0] != 1 or tf.dim_out != 1:
            raise ValueError("the fused scalar filter needs a 1-D rule")
        Wc = tf.Wc.detach().cpu().numpy()
        if tf._emv.numel() != 1:
            raise ValueError("the fused scalar filter needs a scalar model variance")
        rule = Rule(kind=1, xi=_floats(tf.points), wm=_floats(tf.wm),
                    Wc=tuple(tuple(float(v) for v in row) for row in Wc),
                    wcc=_floats(tf.Wcc), emv=float(tf._emv.reshape(())))
    return rule


def _check(mod_dyn, mod_obs):
    """The forms of both models (:func:`~.forms.find_dyn`,
    :func:`~.forms.find_obs`: a registered one, ``"ungm"`` or a measurement
    of ``_OBS_MODELS``); ``ValueError`` with the reason the kernel cannot
    run them."""
    if mod_dyn.dim_state != 1 or mod_obs.dim_out != 1:
        raise ValueError("the fused scalar filter requires dim_state == dim_out == 1")
    if not (mod_dyn.noise_additive and mod_obs.noise_additive):
        raise ValueError("the fused scalar filter requires additive noise")
    dyn, obs = find_dyn(mod_dyn, {}), find_obs(mod_obs, _OBS_MODELS)
    if dyn is None or obs is None:
        raise ValueError("the fused scalar filter has no kernel form of "
                         f"{type(mod_dyn if dyn is None else mod_obs).__name__} (it runs the "
                         "UNGM transition, the UNGM, sine and range measurements and the models "
                         "registered with register_dyn_dd / register_obs_dd or their vector "
                         "counterparts)")
    idx = mod_obs.state_index
    if idx is not None and (len(idx) < 1 or idx[0] != 0):
        raise ValueError(f"state_index {idx} does not pick the component "
                         f"{type(mod_obs).__name__} reads from a state of dimension 1")
    return dyn, obs


def supports(mod_dyn, mod_obs, tf_dyn, tf_obs) -> bool:
    """True if the fused kernel can run this configuration."""
    try:
        prepare(mod_dyn, mod_obs, tf_dyn, tf_obs)
    except ValueError:
        return False
    return True


def _scalar(t) -> float:
    return float(torch.as_tensor(t).reshape(()))


def prepare(mod_dyn, mod_obs, tf_dyn, tf_obs, init_mean=None, init_cov=None) -> ScalarFilterParams:
    """Lower a configuration to :class:`ScalarFilterParams`; ``ValueError``
    names the piece the kernel cannot run.  The models' forms are looked up
    again at every call, so a registration made since takes effect."""
    dyn, obs = _check(mod_dyn, mod_obs)

    (m0_t, P0_t), q_t = mod_dyn.init_rv.get_stats()[:2], mod_dyn.noise_rv.get_stats()[1]
    r_t = mod_obs.noise_rv.get_stats()[1]

    def dyn_consts():
        g = _scalar(mod_dyn.noise_gain)
        return _scalar(m0_t), _scalar(P0_t), g * _scalar(q_t) * g

    m0, P0, gqg = _memo(mod_dyn, "_scalar_filter_consts", (m0_t, P0_t, q_t, mod_dyn.noise_gain),
                        dyn_consts)
    r = _memo(mod_obs, "_scalar_filter_consts", (r_t,), lambda: _scalar(r_t))
    if isinstance(obs, Registered):
        obs_model, obs_c = -1, obs.form.consts
    else:
        obs_model, consts = obs if obs != "ungm" else _OBS_MODELS[UNGMMeasurement]
        obs_c = consts(mod_obs)
    reg = dyn if isinstance(dyn, Registered) else None
    return ScalarFilterParams(
        dyn=lower_transform(tf_dyn), obs=lower_transform(tf_obs),
        m0=m0 if init_mean is None else _scalar(init_mean),
        P0=P0 if init_cov is None else _scalar(init_cov), gqg=gqg, r=r,
        obs_model=obs_model, obs_c=obs_c,
        dyn_form=reg and reg.form, obs_form=obs.form if isinstance(obs, Registered) else None,
        dyn_c=reg.form.consts if reg else (), n_s=reg.n_s if reg else 1,
        streams=reg and reg.streams)


def form_of(params: ScalarFilterParams) -> str:
    """The form of the kernel that runs ``params``: ``"registered"`` for a
    registered model on either side, ``"shaped"`` for the UNGM measurement
    with rules of at most :data:`MAX_PTS` points, else ``"general"``."""
    if params.dyn_form is not None or params.obs_form is not None:
        return "registered"
    if params.obs_model == 0 and max(params.dyn.n, params.obs.n) <= MAX_PTS:
        return "shaped"
    return "general"


def ungm_consts(n_steps: int) -> np.ndarray:
    """UNGM's time-dependent term per step: measurement ``k`` (1-based) uses
    the dynamics at time ``k - 1``, so ``c[k] = 8 cos(1.2 k)`` for the
    0-based step index."""
    return 8.0 * np.cos(1.2 * np.arange(n_steps, dtype=np.float64))


@functools.lru_cache(maxsize=32)
def _ungm_consts_on(n_steps: int, device: torch.device) -> torch.Tensor:
    """:func:`ungm_consts` as a tensor on ``device``, copied there once."""
    return torch.as_tensor(ungm_consts(n_steps), device=device)


def step_consts(params: ScalarFilterParams, n_steps: int, device) -> torch.Tensor:
    """The per-step constants :func:`scalar_filter` takes for ``params``: the
    UNGM transition's :func:`ungm_consts` (n_steps,), or a registered
    transition's streams (n_steps, n_s), on ``device``."""
    if params.dyn_form is None:
        return _ungm_consts_on(n_steps, torch.device(device))
    return forms.on_device(params._on, f"streams_{n_steps}", device,
                           lambda: params.streams(n_steps))


# ---------------------------------------------------------------------------
# the plain PyTorch twin
# ---------------------------------------------------------------------------

def _moments_plain(rule: Rule, L, fs):
    m = 0.0
    for i in range(rule.n):
        m = m + rule.wm[i] * fs[i]
    v = c = 0.0
    if rule.kind == 0:
        for i in range(rule.n):
            d = fs[i] - m
            v = v + rule.wc[i] * (d * d)
            c = c + rule.wc[i] * ((L * rule.xi[i]) * d)
    else:
        q = s = 0.0
        for i in range(rule.n):
            row = 0.0
            for j in range(rule.n):
                row = row + rule.Wc[i][j] * fs[j]
            q = q + fs[i] * row
            s = s + rule.wcc[i] * fs[i]
        v = q - m * m + rule.emv
        c = s * L
    return m, v, c


def _obs_plain(params: ScalarFilterParams, x, sqrt, sin):
    """The measurement of ``params`` at the points ``x``, as the kernel
    evaluates it."""
    if params.obs_model == 1:
        return sin(x)
    if params.obs_model == 2:
        d = x - params.obs_c[1]
        return sqrt(params.obs_c[0] + d * d)
    return 0.05 * (x * x)


def _scalar_filter_plain(params: ScalarFilterParams, y: torch.Tensor, c: torch.Tensor,
                         sqrt=torch.sqrt, sin=torch.sin, fns=None):
    """The kernel's computation as batched torch ops over the B trajectories
    and a Python loop over the N steps; same arguments and results as
    :func:`scalar_filter`, for every form (a registered model through its
    form's ``plain``).  ``sqrt``, ``sin``: the square root and sine to take
    (PyTorch's vectorised CPU ones are an ulp off on some inputs, unlike the
    card's and a C compiler's, so a test that wants equal bits on the CPU
    passes the C library's); ``fns``: the transcendentals a registered form
    takes (:data:`~.forms.TORCH_FNS` with ``sqrt`` and ``sin`` by default)."""
    N, B = y.shape
    fns = fns or SimpleNamespace(**{**vars(TORCH_FNS), "sqrt": sqrt, "sin": sin})
    out = torch.empty((5, N, B), dtype=y.dtype, device=y.device)
    m = torch.full((B,), params.m0, dtype=y.dtype, device=y.device)
    P = torch.full((B,), params.P0, dtype=y.dtype, device=y.device)
    dyn, obs = params.dyn, params.obs
    dyn_form, obs_form = params.dyn_form, params.obs_form
    if dyn_form is not None:
        dyn_c = forms.on_device(params._on, "dyn_c", y.device, lambda: params.dyn_c)
    if obs_form is not None:
        obs_c = forms.on_device(params._on, "obs_c", y.device, lambda: params.obs_c)
    for k in range(N):
        L = sqrt(P)
        fs = []
        for i in range(dyn.n):
            x = m + L * dyn.xi[i]
            fs.append(0.5 * x + 25.0 * (x / (1.0 + x * x)) + c[k] if dyn_form is None else
                      dyn_form.plain(x[:, None], dyn_c, c[k], fns)[:, 0])
        m_pr, Pf, xx = _moments_plain(dyn, L, fs)
        P_pr = Pf + params.gqg
        L2 = sqrt(P_pr)
        hs = []
        for i in range(obs.n):
            x = m_pr + L2 * obs.xi[i]
            hs.append(_obs_plain(params, x, sqrt, sin) if obs_form is None else
                      obs_form.plain(x[:, None], obs_c, fns)[:, 0])
        y_pr, S0, C = _moments_plain(obs, L2, hs)
        S = S0 + params.r
        K = C / S
        m = m_pr + K * (y[k] - y_pr)
        P = P_pr - (K * K) * S
        out[0, k], out[1, k], out[2, k], out[3, k], out[4, k] = m, P, m_pr, P_pr, xx
    return tuple(out)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_STREAMS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int]


class _CGRule(ctypes.Structure):
    """``SfgRule``: a rule of the general form, its constants in memory."""
    _fields_ = [("kind", ctypes.c_int), ("n", ctypes.c_int), ("xi", ctypes.c_void_p),
                ("wm", ctypes.c_void_p), ("wc", ctypes.c_void_p), ("Wc", ctypes.c_void_p),
                ("wcc", ctypes.c_void_p), ("emv", ctypes.c_double)]


class _CGParams(ctypes.Structure):
    """``SfgParams``: the general form's parameters."""
    _fields_ = [("dyn", _CGRule), ("obs", _CGRule), ("obs_model", ctypes.c_int),
                ("obs_c", ctypes.c_double * 2), ("m0", ctypes.c_double),
                ("P0", ctypes.c_double), ("gqg", ctypes.c_double), ("r", ctypes.c_double)]


def _packed(rule: Rule, device) -> torch.Tensor:
    """A rule's constants as one float64 tensor on ``device``: ``xi | wm |
    wc`` or ``xi | wm | Wc | wcc`` (``Wc`` row-major)."""
    vals = rule.xi + rule.wm + (rule.wc if rule.kind == 0 else
                                tuple(v for row in rule.Wc for v in row) + rule.wcc)
    return torch.tensor(vals, dtype=torch.float64, device=device)


def _c_grule(rule: Rule, packed: torch.Tensor) -> _CGRule:
    n, base = rule.n, packed.data_ptr()
    after = base + 16 * n
    if rule.kind == 0:
        return _CGRule(kind=0, n=n, xi=base, wm=base + 8 * n, wc=after)
    return _CGRule(kind=1, n=n, xi=base, wm=base + 8 * n, Wc=after, wcc=after + 8 * n * n,
                   emv=rule.emv)


class _CVec(ctypes.Structure):
    """``SfsVec``: a rule's vectors for the slot design."""
    _fields_ = [(name, ctypes.c_double * MAX_SLOTS) for name in ("xi", "wm", "wc", "wcc")]


class _CSlotRules(ctypes.Structure):
    """``SfsRules``: both rules' vectors, the slot design's by-value
    parameter."""
    _fields_ = [("dyn", _CVec), ("obs", _CVec)]


@functools.lru_cache(maxsize=64)
def _c_slot_rules(p: ScalarFilterParams) -> _CSlotRules:
    """The slot design's vectors of both rules, zero past each rule's points
    (all zero for rules the slot design does not take); built once for a
    given ``p``."""
    c = _CSlotRules()
    if slots(p):
        for rule, vec in ((p.dyn, c.dyn), (p.obs, c.obs)):
            for name in ("xi", "wm", "wc", "wcc"):
                vals = getattr(rule, name)
                getattr(vec, name)[:len(vals)] = vals
    return c


@functools.lru_cache(maxsize=64)
def _c_general_params(p: ScalarFilterParams, device: torch.device) -> _CGParams:
    """The general form's parameter struct with both rules' constants copied
    to ``device`` (kept alive on the struct), built once for a given ``(p,
    device)``."""
    keep = (_packed(p.dyn, device), _packed(p.obs, device))
    c = _CGParams(dyn=_c_grule(p.dyn, keep[0]), obs=_c_grule(p.obs, keep[1]),
                  obs_model=p.obs_model, m0=p.m0, P0=p.P0, gqg=p.gqg, r=p.r)
    if p.obs_form is None:
        c.obs_c[:len(p.obs_c)] = p.obs_c
    c.keep = keep
    return c


class _CRParams(ctypes.Structure):
    """``SfrParams``: the registered form's parameters."""
    _fields_ = [("base", _CGParams), ("dyn_c", ctypes.c_void_p), ("obs_c", ctypes.c_void_p)]


@functools.lru_cache(maxsize=64)
def _c_registered_params(p: ScalarFilterParams, device: torch.device) -> _CRParams:
    """The registered form's parameter struct: :func:`_c_general_params` and
    the registered models' constants copied to ``device`` (kept alive on the
    struct); built once for a given ``(p, device)``."""
    keep = tuple(torch.tensor(v or (0.0,), dtype=torch.float64, device=device)
                 for v in (p.dyn_c, p.obs_c if p.obs_form is not None else ()))
    c = _CRParams(base=_c_general_params(p, device), dyn_c=keep[0].data_ptr(),
                  obs_c=keep[1].data_ptr())
    c.keep = keep
    return c


def _bind(lib: ctypes.CDLL):
    """Declare the argument types of the library's entry points."""
    lib.sf_launch.restype = ctypes.c_int
    lib.sf_launch.argtypes = ([ctypes.POINTER(_CParams)] + _STREAMS + [ctypes.c_int]
                              + [ctypes.c_void_p] * 6)
    lib.sf_geometry.restype = None
    lib.sf_geometry.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.sf_latency.restype = ctypes.c_int
    lib.sf_latency.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.sf_error_string.restype = ctypes.c_char_p
    lib.sf_error_string.argtypes = [ctypes.c_int]
    lib.sfg_launch.restype = ctypes.c_int
    lib.sfg_launch.argtypes = ([ctypes.POINTER(_CGParams), ctypes.POINTER(_CSlotRules)]
                               + _STREAMS + [ctypes.c_int] + [ctypes.c_void_p] * 7)
    _bind_geometry(lib)
    return lib


def _bind_geometry(lib: ctypes.CDLL):
    lib.sf_design.restype = None
    lib.sf_design.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2


#: the library's sources, compiled at once, one nvcc each: the shaped form,
#: the general form's one-thread design and the launchers; the slot design's
#: 28 instantiations on the kernel's own models up to 16 slots; its 12 at 20,
#: 24 and 32 slots
SOURCES = ["scalar_filter.cu", "scalar_filter_slots.cu", "scalar_filter_slots_wide.cu"]


def build() -> ctypes.CDLL:
    """Compile :data:`SOURCES` for sm_90a with nvcc (once) and bind the
    library; later calls return the bound library."""
    return _build.bound("scalar_filter", SOURCES, _bind, _NVCC_FLAGS)


def _bind_host(lib: ctypes.CDLL):
    lib.sf_host_run.restype = ctypes.c_int
    lib.sf_host_run.argtypes = [ctypes.POINTER(_CParams)] + _STREAMS + [ctypes.c_void_p] * 5
    lib.sfg_host_run.restype = ctypes.c_int
    lib.sfg_host_run.argtypes = ([ctypes.POINTER(_CGParams), ctypes.POINTER(_CSlotRules)]
                                 + _STREAMS + [ctypes.c_void_p] * 6)
    _bind_geometry(lib)


def _host_shim() -> ctypes.CDLL:
    """The step header built for the host with g++ (tests only)."""
    return _build.bound("scalar_filter_host", ["scalar_filter_host.cpp"], _bind_host,
                        host=True)


# ---------------------------------------------------------------------------
# the registered form: a library generated from the registered forms
# ---------------------------------------------------------------------------

#: the configurations of the registered libraries built in this process:
#: ``(host, key)`` -> (library, index in its ``SFR_PAIRS``), ``key`` being
#: :func:`_key`
_REGISTERED: dict = {}
#: the arguments of ``sfr_launch`` / ``sfr_host_run`` from ``y`` to ``n_steps``
_R_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p] + [
    ctypes.c_int] * 3


def _model_policy(params: ScalarFilterParams, name: str) -> str:
    """The C++ model policy of ``params``' configuration (see
    ``csrc/scalar_filter_registered.cu``): each registered form's statements
    as a functor of one value, the kernel's own models through ``SfgDyn`` /
    ``SfgObs``."""
    if params.dyn_form is None:
        dyn = ("  SF_HD static SfgDyn dyn(const SfrParams&, const double* s) "
               "{ return {SFG_LDG(s)}; }")
    else:
        dyn = ("  struct Dyn {\n    const double* c;\n    const double* s;\n"
               "    SF_HD double operator()(double x0) const {\n"
               "      const double x[1] = {x0};\n      double f[1];\n"
               f"{forms.c_block(params.dyn_form.source)}\n      return f[0];\n    }}\n  }};\n"
               "  SF_HD static Dyn dyn(const SfrParams& p, const double* s) "
               "{ return {p.dyn_c, s}; }")
    if params.obs_form is None:
        obs = "  SF_HD static SfgObs obs(const SfrParams& p) { return SfgZoo::obs(p.base); }"
    else:
        obs = ("  struct Obs {\n    const double* c;\n"
               "    SF_HD double operator()(double x0) const {\n"
               "      const double x[1] = {x0};\n      double h[1];\n"
               f"{forms.c_block(params.obs_form.source)}\n      return h[0];\n    }}\n  }};\n"
               "  SF_HD static Obs obs(const SfrParams& p) { return {p.obs_c}; }")
    return f"struct {name} {{\n{dyn}\n{obs}\n}};\n"


def _key(params: ScalarFilterParams) -> tuple:
    """What a registered library instantiates for ``params``: its model
    policy, both rules' kinds and its slot count (0: the one-thread
    design)."""
    return (_model_policy(params, "SfrPair"), params.dyn.kind, params.obs.kind, slots(params))


def _registered_header(keys: list) -> str:
    """``sfr_forms.cuh`` for the configurations ``keys`` (:func:`_key`)."""
    parts = ["// Generated by ssmtoybox_torch/ops/scalar_filter.py (build_registered): the",
             "// model policies of the registered configurations.", "#pragma once", ""]
    for i, (policy, *_) in enumerate(keys):
        parts.append(policy.replace("struct SfrPair {", f"struct SfrPair{i} {{", 1))
    pairs = " ".join(f"F({i}, SfrPair{i}, {kd}, {ko}, {n})"
                     for i, (_, kd, ko, n) in enumerate(keys))
    return "\n".join(parts) + f"\n#define SFR_PAIRS(F) {pairs}\n"


def _bind_registered(lib: ctypes.CDLL):
    lib.sfr_launch.restype = ctypes.c_int
    lib.sfr_launch.argtypes = ([ctypes.c_int, ctypes.POINTER(_CRParams),
                                ctypes.POINTER(_CSlotRules)] + _R_ARGS + [ctypes.c_int]
                               + [ctypes.c_void_p] * 7)
    lib.sfr_error_string.restype = ctypes.c_char_p
    lib.sfr_error_string.argtypes = [ctypes.c_int]


def _bind_registered_host(lib: ctypes.CDLL):
    lib.sfr_host_run.restype = ctypes.c_int
    lib.sfr_host_run.argtypes = ([ctypes.c_int, ctypes.POINTER(_CRParams),
                                  ctypes.POINTER(_CSlotRules)] + _R_ARGS
                                 + [ctypes.c_void_p] * 6)


def build_registered(configs, host: bool = False) -> str:
    """Build one library of the registered form for the configurations
    ``configs`` (:class:`ScalarFilterParams` with a registered model) with
    nvcc for sm_90a (with g++, the host build ``sfr_host_run`` of
    ``csrc/scalar_filter_host.cpp``, if ``host``): a header of their model
    policies is generated and only they are instantiated; their launches go
    to it from then on.  A configuration's first launch builds a library for
    it alone if none holds it.  Returns the library's name (its compiler
    output is ``_build.BUILD_LOGS[name]``); a failed build raises
    ``RuntimeError`` with the compiler's output."""
    keys = list(dict.fromkeys(_key(p) for p in configs if form_of(p) == "registered"))
    if not keys:
        raise ValueError("no configuration with a registered model to build")
    if host:
        return forms.build_generated(
            _REGISTERED, keys, _registered_header(keys),
            name="scalar_filter_registered_host", source="scalar_filter_host.cpp",
            file="sfr_forms.cuh", bind=_bind_registered_host, flags=["-DSFR_REGISTERED"],
            host=True)
    return forms.build_generated(
        _REGISTERED, keys, _registered_header(keys), name="scalar_filter_registered",
        source="scalar_filter_registered.cu", file="sfr_forms.cuh", bind=_bind_registered,
        flags=_NVCC_FLAGS, host=False)


def _registered(params: ScalarFilterParams, host: bool) -> tuple:
    """(library, index) of ``params``' configuration, built at first use."""
    key = host, _key(params)
    if key not in _REGISTERED:
        build_registered([params], host)
    return _REGISTERED[key]


def slots(params: ScalarFilterParams) -> int:
    """Points of the instantiation that runs ``params``: the smallest of
    :data:`SLOTS` that holds both rules (``sf_slots`` in the step header); 0
    above :data:`MAX_SLOTS`."""
    return next((n for n in SLOTS if n >= max(params.dyn.n, params.obs.n)), 0)


def geometry(params: ScalarFilterParams, device=None) -> tuple:
    """``(design, slots, lanes)`` of the launch that runs ``params``:
    ``"shaped"`` (the shaped form), ``"slots"`` (the general or registered
    form up to :data:`MAX_SLOTS` points) or ``"one-thread"`` (above it; 0
    slots, 1 lane); the slot count of :func:`slots` and the lanes a
    trajectory the launcher gives that shape.  The step header answers it
    (``sf_design_of``), through the card's library, or through the host
    build where ``device`` (the card for None, as everywhere) is the CPU."""
    lib = _host_shim() if resolve_device(device).type == "cpu" else build()
    shaped = form_of(params) == "shaped"
    n, lanes = ctypes.c_int(), ctypes.c_int()
    lib.sf_design(int(shaped), params.dyn.kind, params.obs.kind, params.dyn.n, params.obs.n,
                  ctypes.byref(n), ctypes.byref(lanes))
    design = "shaped" if shaped else "slots" if n.value else "one-thread"
    return design, n.value, lanes.value


def _check_streams(y: torch.Tensor, c: torch.Tensor, params: ScalarFilterParams | None = None):
    if y.dtype != torch.float64 or c.dtype != torch.float64:
        raise TypeError(f"the scalar filter runs in float64; got {y.dtype} and {c.dtype}")
    want = (y.shape[0],) if params is None or params.dyn_form is None else (y.shape[0], params.n_s)
    if y.ndim != 2 or c.shape != want:
        raise ValueError(f"y must be (N, B) and c {'(N,)' if len(want) == 1 else '(N, n_s)'}; "
                         f"got {tuple(y.shape)} and {tuple(c.shape)}")
    if y.device != c.device:
        raise ValueError(f"y and c on different devices: {y.device} and {c.device}")
    if not ((y.is_contiguous() or y.T.is_contiguous()) and c.is_contiguous()):
        raise ValueError("y must be contiguous, or the transpose of a contiguous (B, N) "
                         "tensor, and c contiguous")
    if y.shape[1] >= 2 ** 31:
        raise ValueError(f"at most 2**31 - 1 trajectories; got {y.shape[1]}")


def _scratch(params: ScalarFilterParams, B: int, device) -> torch.Tensor:
    """The one-thread design's function values of every point, interleaved
    by trajectory; empty for the slot design, which takes none."""
    n = 0 if slots(params) else max(params.dyn.n, params.obs.n) * B
    return torch.empty(n, dtype=torch.float64, device=device)


def _host_shim_run(params: ScalarFilterParams, y: torch.Tensor, c: torch.Tensor):
    """Run the step header of :func:`form_of`'s form compiled for the host
    on CPU tensors; the five streams, after checking that the instantiation
    of :func:`slots` ran (for the general and registered forms, the design of
    :func:`geometry`: its slot count, 1 for the one-thread design)."""
    _check_streams(y, c, params)
    if y.device.type != "cpu":
        raise ValueError(f"the host build takes CPU tensors; got {y.device}")
    N, B = y.shape
    out = torch.empty((5, N, B), dtype=torch.float64)
    form, want = form_of(params), slots(params) or 1
    if form == "registered":
        cpu = torch.device("cpu")
        cr, scratch = _c_registered_params(params, cpu), _scratch(params, B, "cpu")
        lib, pair = _registered(params, host=True)
        ran = lib.sfr_host_run(pair, ctypes.byref(cr), ctypes.byref(_c_slot_rules(params)),
                               y.data_ptr(), y.stride(0), y.stride(1), c.data_ptr(), params.n_s,
                               B, N, *(o.data_ptr() for o in out), scratch.data_ptr())
    elif form == "general":
        cg, scratch = _c_general_params(params, torch.device("cpu")), _scratch(params, B, "cpu")
        ran = _host_shim().sfg_host_run(ctypes.byref(cg), ctypes.byref(_c_slot_rules(params)),
                                        y.data_ptr(), y.stride(0), y.stride(1), c.data_ptr(),
                                        B, N, *(o.data_ptr() for o in out), scratch.data_ptr())
    if form != "shaped":
        if ran != want:
            raise RuntimeError(f"the host build of the {form} form ran design {ran} (slots; 1: "
                               f"one thread) for rules of {params.dyn.n} and {params.obs.n} "
                               f"points, not {want}")
        return tuple(out)
    ran = _host_shim().sf_host_run(ctypes.byref(_c_params(params)), y.data_ptr(), y.stride(0),
                                   y.stride(1), c.data_ptr(), B, N,
                                   *(o.data_ptr() for o in out))
    if ran != slots(params):
        raise RuntimeError(f"the host build ran the {ran}-slot step for rules of "
                           f"{params.dyn.n} and {params.obs.n} points")
    return tuple(out)


def scalar_filter(params: ScalarFilterParams, y: torch.Tensor, c: torch.Tensor):
    """Filter B scalar records in one kernel launch.

    ``y`` (N, B) float64 measurements, time-major: contiguous, or the
    transpose of a contiguous trajectory-major (B, N) tensor (the kernel
    reads it through its strides, no copy is made); ``c`` the per-step
    dynamics constants (:func:`step_consts`: (N,) :func:`ungm_consts`, or a
    registered transition's (N, n_s) streams).  Returns the five contiguous
    (N, B) streams ``(m_fi, P_fi, m_pr, P_pr, xx)``: filtered mean and
    variance, predicted mean and variance, and the dynamics transform's
    cross-covariance.  A CPU tensor runs the plain twin; a CUDA tensor
    launches the kernel's form of :func:`form_of`, in the design of
    :func:`geometry`, on the current stream, without synchronising, or
    raises.
    """
    global LAUNCHES, GENERAL_LAUNCHES, REGISTERED_LAUNCHES, SLOT_LAUNCHES
    _check_streams(y, c, params)
    if y.device.type == "cpu":
        return _scalar_filter_plain(params, y, c)
    if y.device.type != "cuda":
        raise ValueError(f"the scalar filter runs on CPU or CUDA tensors; got {y.device}")
    form = form_of(params)
    general, registered = form == "general", form == "registered"
    lib, pair = _registered(params, host=False) if registered else (build(), None)
    N, B = y.shape
    out = torch.empty((5, N, B), dtype=torch.float64, device=y.device)
    if y.numel() == 0:
        return tuple(out)
    first, size = out.data_ptr(), N * B * 8
    args = (y.data_ptr(), y.stride(0), y.stride(1), c.data_ptr(), B, N, y.device.index or 0,
            *(first + i * size for i in range(5)))
    stream = torch.cuda.current_stream(y.device).cuda_stream
    if registered:
        scratch = _scratch(params, B, y.device)
        rc = lib.sfr_launch(pair, ctypes.byref(_c_registered_params(params, y.device)),
                            ctypes.byref(_c_slot_rules(params)), *args[:4], params.n_s,
                            *args[4:], scratch.data_ptr(), stream)
    elif general:
        scratch = _scratch(params, B, y.device)
        rc = lib.sfg_launch(ctypes.byref(_c_general_params(params, y.device)),
                            ctypes.byref(_c_slot_rules(params)), *args, scratch.data_ptr(),
                            stream)
    else:
        rc = lib.sf_launch(ctypes.byref(_c_params(params)), *args, stream)
    if rc != 0:
        text = (lib.sfr_error_string if registered else lib.sf_error_string)(rc).decode()
        raise RuntimeError(f"scalar filter kernel ({form} form) launch failed: {text} "
                           f"(cudaError {rc})")
    LAUNCHES += 1
    GENERAL_LAUNCHES += int(general)
    REGISTERED_LAUNCHES += int(registered)
    SLOT_LAUNCHES += int(form != "shaped" and slots(params) > 0)
    return tuple(out)


# ---------------------------------------------------------------------------
# the chain floor of the kernel (measurement helpers)
# ---------------------------------------------------------------------------

def dependent_latencies(device: torch.device, iters: int = 512, lib=None) -> dict:
    """Clocks from one dependent float64 operation to the next on the card
    ``device``, measured by the library's ``sf_latency`` kernel (one warp,
    ``16 * iters`` operations of each type between two reads of the SM's
    clock): ``add``, ``mul``, ``div``, ``sqrt`` (the add that feeds it back
    taken off), ``shfl`` (a double moved by two shuffles), and the vector
    filter's ``exp`` (the multiply that feeds it back taken off), ``atan2``
    and ``sin`` (the add that feeds it back taken off)."""
    lib = build() if lib is None else lib
    out = torch.zeros(9, dtype=torch.float64, device=device)
    rc = lib.sf_latency(device.index or 0, iters, out.data_ptr(),
                        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sf_latency launch failed: {lib.sf_error_string(rc).decode()}")
    add, mul, div, root, shfl, exp_mul, atan2, sin_add = (float(v) for v in out[:8].cpu())
    return {"add": add, "mul": mul, "div": div, "sqrt": root - add, "shfl": shfl,
            "exp": exp_mul - mul, "atan2": atan2, "sin": sin_add - add}


def chain_floor_clocks(lat: dict, params: ScalarFilterParams) -> float:
    """Clocks of the critical path of one filter step, whatever the number of
    lanes: the operations that each wait for the one before.  Two square
    roots and two divides (the dynamics' and the gain's); for each rule the
    point (2), the mean (``n`` adds after a multiply) and the variance (3
    operations to its first term, ``n`` adds; a BQ rule's row sum and
    quadratic form are as long); the dynamics (5 around its divide) and the
    measurement function (2); the noise terms (2) and the update (3):
    ``2 (n_dyn + n_obs) + 24`` adds and multiplies; and a gather for each rule
    (two for a BQ rule) where a trajectory has more than one lane."""
    plain = 0.5 * (lat["add"] + lat["mul"])
    gathers = sum(1 + rule.kind for rule in (params.dyn, params.obs))
    return (2.0 * lat["sqrt"] + 2.0 * lat["div"]
            + (2 * (params.dyn.n + params.obs.n) + 24) * plain + gathers * lat["shfl"])


# ---------------------------------------------------------------------------
# model-level entry points
# ---------------------------------------------------------------------------

def scalar_filter_moments(mod_dyn, mod_obs, tf_dyn, tf_obs, data_batch,
                          init_mean=None, init_cov=None, params=None):
    """The five (N, B) moment streams of :func:`scalar_filter` for a batch of
    records ``data_batch`` (B, 1, N) or (B, N), on the data's device.
    ``params``: the configuration already lowered by :func:`prepare`."""
    ys = data_batch[:, 0, :] if data_batch.ndim == 3 else data_batch
    if params is None:
        params = prepare(mod_dyn, mod_obs, tf_dyn, tf_obs, init_mean, init_cov)
    ys = ys.to(torch.float64)
    y = ys.T if ys.is_contiguous() else ys.T.contiguous()
    return scalar_filter(params, y, step_consts(params, y.shape[0], y.device))


def scalar_filter_batch(mod_dyn, mod_obs, tf_dyn, tf_obs, data_batch):
    """Filtered means of a batch of scalar records.

    ``data_batch`` (B, 1, N) or (B, N) float64; returns (B, 1, N), the JAX
    contract of ``ops.ddfilter.scalar_filter_batch``.
    """
    m_fi = scalar_filter_moments(mod_dyn, mod_obs, tf_dyn, tf_obs, data_batch)[0]
    return m_fi.T[:, None, :]
