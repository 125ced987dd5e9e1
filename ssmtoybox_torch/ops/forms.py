"""Model forms registered at run time for the fused filter kernels.

The JAX package's dd engines take any additive-noise model that a user
registers with an evaluator in double-double arithmetic
(``ops/ddfilter.py:71-84`` for 1-D states, ``ops/ddvec.py:65-81`` for states
of up to 8 dimensions).  The port's counterpart of such an evaluator is a
:class:`KernelForm`: the model's function as C++ statements that the kernels
compile in (``csrc/scalar_filter_registered.cu``,
``csrc/vector_filter_registered.cu``, through a header generated from the
forms), its constants, and the same function in PyTorch for the plain
versions.  The four registries live here and are filled through
``ops.vector_filter.register_dyn_dd_vec`` / ``register_obs_dd_vec`` and
``ops.scalar_filter.register_dyn_dd`` / ``register_obs_dd``;
:func:`find_dyn` and :func:`find_obs` look a model up as the JAX package's
``ddvec._dyn_lower_for`` / ``_obs_lower_for`` do.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch

from ..ssmod import UNGMMeasurement, UNGMTransition
from . import _build

__all__ = ["KernelForm", "TORCH_FNS", "find_dyn", "find_obs"]

#: the transcendentals of the plain versions, PyTorch's: on the card these are
#: CUDA's libm, as in the kernels.  A host build of the kernels' headers calls
#: the C library's, which PyTorch's vectorised CPU ``exp``, ``sqrt``, ``sin``,
#: ``cos`` and ``atan2`` may be an ulp off; the plain versions take others
#: through ``fns``.
TORCH_FNS = SimpleNamespace(sqrt=torch.sqrt, exp=torch.exp, sin=torch.sin, cos=torch.cos,
                            atan2=torch.atan2)


@dataclass(frozen=True)
class KernelForm:
    """A model's function in the form the fused filter kernels compile.

    ``source``: C++ statements, the body of a ``__host__ __device__``
    function in float64.  A transition reads the state ``x[0 .. D)``, its
    constants ``c[...]`` and this step's values of its per-step streams
    ``s[...]`` (one per stream, in the order of the streams) and writes
    ``f[0 .. D)``.  A measurement reads ``x[0 .. D)`` (the whole state: it
    gathers the components it reads itself, as the JAX package's evaluators
    do; a form of the scalar registry reads ``x[0]``, the component its
    ``state_index`` picks) and ``c[...]`` and writes ``h[0 .. E)``.  The C
    math library's functions (``sqrt``, ``exp``, ``sin``, ``cos``,
    ``atan2``, ...) are at hand.  Nothing else of the program is.

    ``consts``: the constants ``c``, read from device memory, any number.

    ``plain``: the same function on PyTorch tensors, for the plain versions
    (what a CPU tensor runs): ``plain(x, c, s, fns)`` for a transition, ``x``
    the points (..., D), ``c`` the constants and ``s`` this step's stream
    values as 1-D float64 tensors on the points' device (index them:
    ``c[0]`` is a 0-dim tensor), ``fns`` the transcendentals
    (:data:`TORCH_FNS` or the C library's in a test); it returns (..., D).
    ``plain(x, c, fns)`` for a measurement returns (..., E).

    The kernel agrees with its plain version to the bit only where the two
    perform the same float64 operations in the same order (kernels are built
    without multiply-add contraction) and their transcendentals agree:
    write ``plain`` as ``source`` is written, operation by operation, and
    divide by a tensor, never by a Python number (PyTorch divides a CUDA
    tensor by a number as a product with its reciprocal).
    """

    source: str
    consts: tuple = ()
    plain: Callable | None = field(default=None, compare=False)

    def __post_init__(self):
        if not isinstance(self.source, str) or not self.source.strip():
            raise ValueError("a KernelForm's source is C++ statements, a non-empty str")
        object.__setattr__(self, "consts",
                           tuple(float(v) for v in np.asarray(self.consts, np.float64).ravel()))
        if not callable(self.plain):
            raise ValueError("a KernelForm needs its plain PyTorch version (plain=)")


@dataclass(frozen=True)
class Registered:
    """A registered model's form bound to a model: ``form``, and for a
    transition ``streams(n_steps)``, its per-step streams as one (n_steps,
    n_s) float64 array, ``n_s`` of them; ``index``: for a scalar form read on
    a vector state, the state component it reads (its ``state_index``)."""

    form: KernelForm
    streams: Callable | None = field(default=None, compare=False)
    n_s: int = 0
    index: int | None = None


#: the vector registry, class -> lower, looked up through the MRO
#: (``ddvec._DYN_DD_VEC`` / ``_OBS_DD_VEC``)
DYN_DD_VEC: dict = {}
OBS_DD_VEC: dict = {}
#: the scalar registry, looked up by exact type (``ddfilter._DYN_DD`` /
#: ``_OBS_DD``): class -> (step_consts, form) and class -> form, a form or a
#: function of the model giving one
DYN_DD: dict = {}
OBS_DD: dict = {}


def _form_of(made, what: str) -> KernelForm:
    if not isinstance(made, KernelForm):
        raise ValueError(f"the registered {what} gave {type(made).__name__}, not a KernelForm")
    return made


def _stacked(streams, n_steps: int) -> np.ndarray:
    """Per-step streams (a list of (n_steps,) arrays) as one (n_steps, n_s)
    array."""
    cols = [np.asarray(s, np.float64).reshape(-1) for s in streams]
    if any(c.shape != (n_steps,) for c in cols):
        raise ValueError(f"each per-step stream must have {n_steps} values; got "
                         f"{[c.shape for c in cols]}")
    return np.stack(cols, axis=1) if cols else np.zeros((n_steps, 0))


def _vec_dyn(lower, model) -> Registered:
    streams, form = lower(model, 1)
    return Registered(_form_of(form, "transition's lower"),
                      lambda n: _stacked(lower(model, n)[0], n), len(streams))


def _scalar_dyn(entry, model) -> Registered:
    step_consts, form = entry
    form = form if isinstance(form, KernelForm) else form(model)
    return Registered(_form_of(form, "transition"),
                      lambda n: _stacked([step_consts(model, n)], n), 1)


def find_dyn(model, zoo: dict):
    """The kernel form of a transition, looked up as ``ddvec._dyn_lower_for``:
    the vector registry and the kernels' own table ``zoo`` through the MRO (a
    class's own entry first, a registration before the table's entry of the
    same class), then, for a 1-D state, the scalar registry by exact type
    and the kernels' own UNGM transition.  A :class:`Registered` form, a
    ``zoo`` entry, ``"ungm"``, or None if there is none."""
    for t in type(model).__mro__:
        if t in DYN_DD_VEC:
            return _vec_dyn(DYN_DD_VEC[t], model)
        if t in zoo:
            return zoo[t]
    if model.dim_state == 1:
        t = type(model)
        if t in DYN_DD:
            return _scalar_dyn(DYN_DD[t], model)
        if t is UNGMTransition:
            return "ungm"
    return None


def _index(model) -> int:
    return model.state_index[0] if model.state_index is not None else 0


def find_obs(model, zoo: dict):
    """The kernel form of a measurement, looked up as
    ``ddvec._obs_lower_for``: the vector registry and the kernels' own table
    ``zoo`` through the MRO, then, for one output, the scalar registry by
    exact type (the form reads the component ``state_index`` picks) and the
    kernels' own UNGM measurement.  A :class:`Registered` form, a ``zoo``
    entry, ``"ungm"``, or None."""
    for t in type(model).__mro__:
        if t in OBS_DD_VEC:
            return Registered(_form_of(OBS_DD_VEC[t](model), "measurement's lower"))
        if t in zoo and t is not UNGMMeasurement:
            return zoo[t]
    if model.dim_out == 1:
        t = type(model)
        if t in OBS_DD:
            form = OBS_DD[t] if isinstance(OBS_DD[t], KernelForm) else OBS_DD[t](model)
            return Registered(_form_of(form, "measurement"), index=_index(model))
        if t is UNGMMeasurement:
            return "ungm"
    return None


def c_block(source: str) -> str:
    """``source`` indented as the body of a generated function."""
    return "\n".join("    " + line if line.strip() else "" for line in source.splitlines())


def on_device(cache: dict, what: str, device, make) -> torch.Tensor:
    """``make()`` as a float64 tensor on ``device``, made once for ``cache``
    (a parameter object's own dictionary) and kept there."""
    key = (what, torch.device(device))
    t = cache.get(key)
    if t is None:
        t = cache[key] = torch.as_tensor(np.asarray(make(), np.float64), device=device)
    return t


def build_generated(libraries: dict, keys: list, header: str, *, name: str, source: str,
                    file: str, bind, flags, host: bool) -> str:
    """Build ``source`` (a file of ``csrc``) with the generated header
    ``header``, named ``file``, into one library that holds the
    configurations ``keys``: with nvcc and ``flags``, or with g++ and
    ``flags`` if ``host``.  Records ``(library, index)`` of each key in
    ``libraries[host, key]`` and returns the library's name (its compiler
    output is ``_build.BUILD_LOGS[name]``); a failed build raises
    ``RuntimeError`` with the compiler's output and records nothing."""
    generated = {file: header}
    lib = _build.bound(name, [source], bind, flags, host=host, generated=generated)
    for i, key in enumerate(keys):
        libraries[host, key] = (lib, i)
    return _build.generated_name(name, generated)
