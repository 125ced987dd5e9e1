"""Hand-written CUDA kernels of the port, each with its plain PyTorch twin.

- :mod:`.scalar_filter` — the whole-record scalar filter kernel: the UNGM
  transition with the UNGM, sine or range measurement, 1-D rules of any
  point count (a shaped form for the UNGM measurement at up to 8 points, a
  general one for the rest).
- :mod:`.vector_filter` — the whole-record filter kernels for states of
  dimension 2-8: every transition of its table (reentry, constant velocity,
  the pendulum, the falling body, the coordinated turn) with every
  measurement of it (the radar, the sine, the range, UNGM of a state
  component, bearings from 1-8 sensors).
- :mod:`.student_mc` — the RBF-Student Monte-Carlo expectations and their
  gradients (four kernels).
- :mod:`.vandermonde` — the Vandermonde matrix of multivariate monomials.

:func:`dd_check` says whether ``engine="dd"`` can run a configuration.
"""
from . import scalar_filter as _sf, vector_filter as _vf
from .scalar_filter import scalar_filter_batch, supports
from .student_mc import student_kxy, student_qrq

__all__ = ["dd_check", "scalar_filter_batch", "supports", "student_qrq", "student_kxy"]


def dd_check(mod_dyn, mod_obs, tf_dyn, tf_obs) -> None:
    """Raise ``ValueError`` with the reason ``engine="dd"`` cannot run this
    configuration (the counterpart of ``ssmtoybox_tpu.ops.ddvec.dd_check``,
    which admits the same configurations but bearings from more than 8
    sensors); return None when one of the fused filter kernels takes it.  The check is
    the lowering :func:`ssmtoybox_torch.ssinf.gaussian_filter_batch` runs:
    the scalar kernel's for a 1-D state, the vector kernels' above."""
    lowering = _sf if mod_dyn.dim_state == 1 else _vf
    lowering.prepare(mod_dyn, mod_obs, tf_dyn, tf_obs)
