"""Hand-written CUDA kernels of the port, each with its plain PyTorch twin.

- :mod:`.scalar_filter` — the whole-record scalar filter kernel: the UNGM
  transition with the UNGM, sine or range measurement, 1-D rules of any
  point count (a shaped form for the UNGM measurement at up to 8 points, a
  general one for the rest), and 1-D models registered at run time (the
  registered form).
- :mod:`.vector_filter` — the whole-record filter kernels for states of
  dimension 2-8: every transition of its table (reentry, constant velocity,
  the pendulum, the falling body, the coordinated turn) with every
  measurement of it (the radar, the sine, the range, UNGM of a state
  component, bearings from any number of sensors), and models registered at
  run time (the registered kernel).
- :mod:`.forms` — :class:`KernelForm`, a registered model's C++ statements,
  constants and plain PyTorch version, and the registries.
- :mod:`.student_mc` — the RBF-Student Monte-Carlo expectations and their
  gradients (four kernels).
- :mod:`.vandermonde` — the Vandermonde matrix of multivariate monomials.

A user's model runs in the fused kernels once registered, as in the JAX
package's ``ops.ddvec`` / ``ops.ddfilter``: :func:`register_dyn_dd_vec` and
:func:`register_obs_dd_vec` (any state of up to 8 dimensions, found through
the class's MRO), :func:`register_dyn_dd` and :func:`register_obs_dd` (one
dimension, found by exact type).  :func:`dd_check` says whether
``engine="dd"`` can run a configuration.
"""
from . import scalar_filter as _sf, vector_filter as _vf
from .forms import KernelForm
from .scalar_filter import register_dyn_dd, register_obs_dd, scalar_filter_batch, supports
from .student_mc import student_kxy, student_qrq
from .vector_filter import register_dyn_dd_vec, register_obs_dd_vec

__all__ = ["dd_check", "KernelForm", "register_dyn_dd_vec", "register_obs_dd_vec",
           "register_dyn_dd", "register_obs_dd", "scalar_filter_batch", "supports",
           "student_qrq", "student_kxy"]


def dd_check(mod_dyn, mod_obs, tf_dyn, tf_obs) -> None:
    """Raise ``ValueError`` with the reason ``engine="dd"`` cannot run this
    configuration (the counterpart of ``ssmtoybox_tpu.ops.ddvec.dd_check``,
    which admits the same configurations under the same registrations);
    return None when one of the fused filter kernels takes it.  The check is
    the lowering :func:`ssmtoybox_torch.ssinf.gaussian_filter_batch` runs:
    the scalar kernel's for a 1-D state, the vector kernels' above."""
    lowering = _sf if mod_dyn.dim_state == 1 else _vf
    lowering.prepare(mod_dyn, mod_obs, tf_dyn, tf_obs)
