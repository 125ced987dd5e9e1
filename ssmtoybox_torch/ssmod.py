"""State-space models and simulators (counterpart of :mod:`ssmtoybox_tpu.ssmod`).

The univariate nonlinear growth model (UNGM), the 2-D reentry vehicle and
the constant-velocity target with the range-bearing radar, additive noise.
Noise and initial-state RVs may be Gaussian, Student-t or Gaussian mixtures
(anything with ``sample`` and ``get_stats``).  Model
functions take states of shape (..., D) and broadcast over the leading
dimensions, which replaces the JAX package's per-state functions under
``vmap``.  Simulators draw from an explicit ``torch.Generator`` that lives on
the models' device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .utils.arrays import f64
from .utils.ode import ode_euler

__all__ = [
    "TransitionModel", "MeasurementModel",
    "UNGMTransition", "ReentryVehicle2DTransition", "ConstantVelocity",
    "UNGMMeasurement", "Radar2DMeasurement",
]


def _cos(t):
    return torch.cos(t) if isinstance(t, torch.Tensor) else math.cos(t)


# ---------------------------------------------------------------------------
# Transition models
# ---------------------------------------------------------------------------

class TransitionModel:
    """Base transition model, additive noise.

    Subclasses set the class attributes ``dim_state`` and ``dim_noise`` and
    implement ``dyn_fcn(x, q, time)``.
    """

    dim_state = 0
    dim_noise = 0
    noise_additive = True

    def __init__(self, init_rv, noise_rv, noise_gain=None):
        self.init_rv = init_rv
        self.noise_rv = noise_rv
        self.noise_gain = (torch.eye(self.dim_state, self.dim_noise, dtype=torch.float64,
                                     device=init_rv.device)
                           if noise_gain is None else f64(noise_gain, init_rv.device))

    @property
    def dim_in(self) -> int:
        """Input dim of the dynamics function (additive noise: the state dim)."""
        return self.dim_state

    @property
    def device(self) -> torch.device:
        return self.init_rv.device

    def dyn_fcn(self, x, q, time):  # pragma: no cover - interface
        raise NotImplementedError

    def dyn_fcn_cont(self, x, q, time):
        """The continuous-time dynamics ``dx/dt = f(x, q, t)``; models without
        one raise."""
        raise NotImplementedError(f"{type(self).__name__} has no continuous-time dynamics")

    def dyn_eval(self, x, time):
        """The dynamics at zero noise, the function a filter transforms."""
        return self.dyn_fcn(x, x.new_zeros(x.shape[:-1] + (self.dim_noise,)), time)

    def simulate_discrete(self, gen: torch.Generator, steps: int, mc_sims: int = 1):
        """Discrete-time trajectories, (dim_state, steps, mc_sims); ``x[:, 0]``
        are the sampled initial conditions and step ``k -> k+1`` uses time ``k``."""
        x = self.init_rv.sample(gen, (mc_sims,)).T                 # (M, D)
        q = self.noise_rv.sample(gen, (steps, mc_sims))            # (Dq, steps, M)
        xs = [x]
        for k in range(steps - 1):
            x = self.dyn_fcn(x, q[:, k].T, k)
            xs.append(x)
        return torch.stack(xs).permute(2, 0, 1)

    def simulate_continuous(self, gen: torch.Generator, duration: float, dt: float = 0.1,
                            mc_sims: int = 1):
        """Euler-Maruyama trajectories of the continuous-time dynamics,
        (dim_state, steps, mc_sims) with ``steps = floor(duration / dt)``;
        the initial condition is dropped, as in the reference.  The noise is
        scaled by ``sqrt(dt) / dt`` so that ``V[dt q_k] = dt Q``."""
        steps = int(np.floor(duration / dt))
        x0 = self.init_rv.sample(gen, (mc_sims,)).T                # (M, D)
        q = (math.sqrt(dt) / dt) * self.noise_rv.sample(gen, (steps + 1, mc_sims))
        return self.euler_maruyama(x0, q[:, :steps], dt)

    def euler_maruyama(self, x0: torch.Tensor, q: torch.Tensor, dt: float) -> torch.Tensor:
        """The integration of :meth:`simulate_continuous` from initial states
        ``x0`` (M, D) with scaled noise ``q`` (Dq, steps, M): step ``k`` is
        ``x + dt f(x, q_k, k)``.  Returns (dim_state, steps, M)."""
        x, xs = x0, []
        for k in range(q.shape[1]):
            x = ode_euler(self.dyn_fcn_cont, x, q[:, k].T, k, dt)
            xs.append(x)
        return torch.stack(xs).permute(2, 0, 1)


class UNGMTransition(TransitionModel):
    """Univariate nonlinear growth model, ``0.5x + 25x/(1+x^2) + 8cos(1.2t) + q``."""

    dim_state = 1
    dim_noise = 1

    def dyn_fcn(self, x, q, time):
        return 0.5 * x + 25.0 * (x / (1.0 + x ** 2)) + 8.0 * _cos(1.2 * time) + q


class ReentryVehicle2DTransition(TransitionModel):
    """2-D reentry radar-tracking benchmark (Julier & Uhlmann 2004); noise gain
    ``G = [0_{2x3}; I_3]`` by default."""

    dim_state = 5
    dim_noise = 3

    def __init__(self, init_rv, noise_rv, noise_gain=None, dt: float = 0.1,
                 R0: float = 6374.0, H0: float = 13.406, Gm0: float = 3.9860e5,
                 b0: float = -0.59783):
        if noise_gain is None:
            noise_gain = np.vstack((np.zeros((2, self.dim_noise)), np.eye(self.dim_noise)))
        super().__init__(init_rv, noise_rv, noise_gain)
        self.dt, self.R0, self.H0, self.Gm0, self.b0 = dt, R0, H0, Gm0, b0

    def _drag_gravity(self, x):
        x0, x1, x2, x3, x4 = x.unbind(-1)
        R = torch.sqrt(x0 ** 2 + x1 ** 2)
        V = torch.sqrt(x2 ** 2 + x3 ** 2)
        # b0 exp(x4) exp((R0 - R)/H0) V with the two exponentials fused, as
        # the JAX package writes it
        D = self.b0 * torch.exp(x4 + (self.R0 - R) / self.H0) * V
        G = -self.Gm0 / R ** 3
        return D, G

    def dyn_fcn_cont(self, x, q, time):
        x0, x1, x2, x3, _ = x.unbind(-1)
        D, G = self._drag_gravity(x)
        return torch.stack([x2, x3, D * x2 + G * x0 + q[..., 0], D * x3 + G * x1 + q[..., 1],
                            q[..., 2]], dim=-1)

    def dyn_fcn(self, x, q, time):
        x0, x1, x2, x3, x4 = x.unbind(-1)
        D, G = self._drag_gravity(x)
        dt = self.dt
        return torch.stack([
            x0 + dt * x2,
            x1 + dt * x3,
            x2 + dt * (D * x2 + G * x0) + q[..., 0],
            x3 + dt * (D * x3 + G * x1) + q[..., 1],
            x4 + q[..., 2],
        ], dim=-1)


class ConstantVelocity(TransitionModel):
    """Constant-velocity target in the plane, state ``[p_x, v_x, p_y, v_y]``;
    noise gain ``[[dt^2/2, 0], [dt, 0], [0, dt^2/2], [0, dt]]`` by default."""

    dim_state = 4
    dim_noise = 2

    def __init__(self, init_rv, noise_rv, noise_gain=None, dt: float = 0.1):
        if noise_gain is None:
            noise_gain = np.array([[dt ** 2 / 2, 0.0], [dt, 0.0],
                                   [0.0, dt ** 2 / 2], [0.0, dt]])
        super().__init__(init_rv, noise_rv, noise_gain)
        self.dt = dt

    def dyn_fcn(self, x, q, time):
        x0, x1, x2, x3 = x.unbind(-1)
        dt = self.dt
        return torch.stack([x0 + dt * x1, x1, x2 + dt * x3, x3], dim=-1) + q @ self.noise_gain.T


# ---------------------------------------------------------------------------
# Measurement models
# ---------------------------------------------------------------------------

class MeasurementModel:
    """Base measurement model, additive noise; ``state_index`` selects the
    sub-state the measurement function sees."""

    dim_out = 0
    dim_noise = 0
    noise_additive = True

    def __init__(self, noise_rv, dim_state: int, state_index=None):
        self.noise_rv = noise_rv
        self.dim_state = int(dim_state)
        self.state_index = (None if state_index is None else
                            tuple(int(i) for i in np.asarray(state_index).ravel()))

    @property
    def dim_in(self) -> int:
        return self.dim_state

    @property
    def device(self) -> torch.device:
        return self.noise_rv.device

    def meas_fcn(self, x, r, time):  # pragma: no cover - interface
        raise NotImplementedError

    def _select(self, x):
        return x if self.state_index is None else x[..., list(self.state_index)]

    def meas_eval(self, x, time):
        """Sub-state selection, then the measurement at zero noise."""
        x = self._select(x)
        return self.meas_fcn(x, x.new_zeros(x.shape[:-1] + (self.dim_noise,)), time)

    def simulate_measurements(self, gen: torch.Generator, x: torch.Tensor):
        """Measurements of ``x`` (dim_state, steps, mc_sims), shaped
        (dim_out, steps, mc_sims); array index ``k`` carries time ``k + 1``."""
        xs = self._select(x.permute(1, 2, 0))                      # (steps, M, d)
        steps, mc_sims = xs.shape[:2]
        r = self.noise_rv.sample(gen, (steps, mc_sims)).permute(1, 2, 0)
        ys = [self.meas_fcn(xs[k], r[k], k + 1) for k in range(steps)]
        return torch.stack(ys).permute(2, 0, 1)


class UNGMMeasurement(MeasurementModel):
    """``z = 0.05 x^2 + r``."""

    dim_out = 1
    dim_noise = 1

    def meas_fcn(self, x, r, time):
        return 0.05 * x ** 2 + r


class Radar2DMeasurement(MeasurementModel):
    """Range and bearing from a radar at ``radar_loc``."""

    dim_out = 2
    dim_noise = 2

    def __init__(self, noise_rv, dim_state: int, state_index=None, radar_loc=None):
        super().__init__(noise_rv, dim_state, state_index)
        self.radar_loc = f64(np.zeros(2) if radar_loc is None else radar_loc, noise_rv.device)

    def meas_fcn(self, x, r, time):
        dx = x[..., 0] - self.radar_loc[0]
        dy = x[..., 1] - self.radar_loc[1]
        return torch.stack([torch.sqrt(dx ** 2 + dy ** 2), torch.atan2(dy, dx)], dim=-1) + r
