"""State-space models and simulators (counterpart of :mod:`ssmtoybox_tpu.ssmod`).

The JAX package's model zoo: the univariate nonlinear growth model (UNGM)
with additive and non-additive noise, the pendulum, the 1-D and 2-D reentry
vehicles, the coordinated-turn and constant turn-rate-and-speed targets and
the constant-velocity target; measured by the UNGM, pendulum, range,
bearings-only and range-bearing radar models.  Noise and initial-state RVs
may be Gaussian, Student-t or Gaussian mixtures (anything with ``sample`` and
``get_stats``).  Model functions take states of shape (..., D) and broadcast
over the leading dimensions, which replaces the JAX package's per-state
functions under ``vmap``.  Simulators draw from an explicit
``torch.Generator`` that lives on the models' device.

A model with ``noise_additive = False`` takes its noise inside the function:
``dyn_eval`` / ``meas_eval`` read the augmented input ``[x, q]`` and split
it, as the JAX package does, and the filters augment the moments to match.
``dyn_fcn_dx`` / ``meas_fcn_dx`` are Jacobians by ``torch.func.jacfwd``; a
non-additive model's include the noise columns.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .utils.arrays import f64
from .utils.autodiff import jacobian
from .utils.ode import ode_euler

__all__ = [
    "TransitionModel", "MeasurementModel",
    "UNGMTransition", "UNGMNATransition", "Pendulum2DTransition",
    "ReentryVehicle1DTransition", "ReentryVehicle2DTransition",
    "CoordinatedTurnTransition", "ConstantTurnRateSpeed", "ConstantVelocity",
    "UNGMMeasurement", "UNGMNAMeasurement", "Pendulum2DMeasurement",
    "RangeMeasurement", "BearingMeasurement", "Radar2DMeasurement",
]

#: turn rates below this take the straight-line limit in the turning models
#: (the JAX package's select, kept so that both take the same branch)
_TINY = 1e-30


def _cos(t):
    return torch.cos(t) if isinstance(t, torch.Tensor) else math.cos(t)


# ---------------------------------------------------------------------------
# Transition models
# ---------------------------------------------------------------------------

class TransitionModel:
    """Base transition model.

    Subclasses set the class attributes ``dim_state``, ``dim_noise`` and
    ``noise_additive`` and implement ``dyn_fcn(x, q, time)``.
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
        """Input dim of the dynamics function: the state's, with the noise's
        added for non-additive noise."""
        return self.dim_state if self.noise_additive else self.dim_state + self.dim_noise

    @property
    def device(self) -> torch.device:
        return self.init_rv.device

    def dyn_fcn(self, x, q, time):  # pragma: no cover - interface
        raise NotImplementedError

    def dyn_fcn_cont(self, x, q, time):
        """The continuous-time dynamics ``dx/dt = f(x, q, t)``; models without
        one raise."""
        raise NotImplementedError(f"{type(self).__name__} has no continuous-time dynamics")

    def dyn_fcn_dx(self, x, q, time):
        """Jacobian of ``dyn_fcn`` at states ``x`` (..., D) and noise ``q``
        (..., Dq): (..., D, D); a non-additive model's is taken with respect
        to ``[x, q]``, (..., D, D + Dq), as the JAX package's."""
        argnums = (0,) if self.noise_additive else (0, 1)
        return jacobian(lambda v, w: self.dyn_fcn(v, w, time), (x, q), argnums)

    def dyn_eval(self, x, time):
        """The function a filter transforms: the dynamics at zero noise, or,
        for non-additive noise, of the augmented input ``x = [state, q]``."""
        if self.noise_additive:
            return self.dyn_fcn(x, x.new_zeros(x.shape[:-1] + (self.dim_noise,)), time)
        return self.dyn_fcn(x[..., :self.dim_state], x[..., -self.dim_noise:], time)

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


class UNGMNATransition(TransitionModel):
    """UNGM with non-additive noise, ``0.5x + 25x/(1+x^2) + 8 q cos(1.2t)``."""

    dim_state = 1
    dim_noise = 1
    noise_additive = False

    def dyn_fcn(self, x, q, time):
        return 0.5 * x + 25.0 * (x / (1.0 + x ** 2)) + 8.0 * q * _cos(1.2 * time)


class Pendulum2DTransition(TransitionModel):
    """Pendulum (Sarkka, example 5.1), state ``[angle, angular rate]``."""

    dim_state = 2
    dim_noise = 2

    def __init__(self, init_rv, noise_rv, noise_gain=None, dt: float = 0.01, g: float = 9.81):
        super().__init__(init_rv, noise_rv, noise_gain)
        self.dt, self.g = dt, g

    def dyn_fcn(self, x, q, time):
        x0, x1 = x.unbind(-1)
        return torch.stack([x0 + x1 * self.dt,
                            x1 - self.g * self.dt * torch.sin(x0)], dim=-1) + q


class ReentryVehicle1DTransition(TransitionModel):
    """1-D reentry vehicle (Julier & Uhlmann 1996), state ``[altitude,
    velocity, ballistic coefficient]``."""

    dim_state = 3
    dim_noise = 3

    def __init__(self, init_rv, noise_rv, noise_gain=None, dt: float = 0.1,
                 Gamma: float = 1.0 / 6.096):
        super().__init__(init_rv, noise_rv, noise_gain)
        self.dt, self.Gamma = dt, Gamma

    def dyn_fcn(self, x, q, time):
        x0, x1, x2 = x.unbind(-1)
        q0, q1, q2 = q.unbind(-1)
        return torch.stack([
            x0 - self.dt * x1 + q0,
            x1 - self.dt * torch.exp(-self.Gamma * x0) * x1 ** 2 * x2 + q1,
            x2 + q2,
        ], dim=-1)

    def dyn_fcn_cont(self, x, q, time):
        x0, x1, x2 = x.unbind(-1)
        q0, q1, q2 = q.unbind(-1)
        return torch.stack([-x1 + q0, -torch.exp(-self.Gamma * x0) * x1 ** 2 * x2 + q1, q2],
                           dim=-1)


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


class CoordinatedTurnTransition(TransitionModel):
    """Coordinated turn with unknown turn rate, state ``[p_x, v_x, p_y, v_y,
    turn rate]``.  Below a turn rate of 1e-30 the straight-line limit
    (``c -> dt``, ``d -> 0``) is selected and the divisions see 1e-30, as in
    the JAX package, so that any input gives finite values."""

    dim_state = 5
    dim_noise = 5

    def __init__(self, init_rv, noise_rv, noise_gain=None, dt: float = 0.1):
        super().__init__(init_rv, noise_rv, noise_gain)
        self.dt = dt

    def dyn_fcn(self, x, q, time):
        x0, x1, x2, x3, om = x.unbind(-1)
        straight = om.abs() < _TINY
        om_safe = torch.where(straight, _TINY, om)
        a = torch.sin(om * self.dt)
        b = torch.cos(om * self.dt)
        c = torch.where(straight, self.dt, a / om_safe)
        d = torch.where(straight, 0.0, (1.0 - b) / om_safe)
        return torch.stack([x0 + c * x1 - d * x3, b * x1 - a * x3, x2 + d * x1 + c * x3,
                            a * x1 + b * x3, om], dim=-1) + q


class ConstantTurnRateSpeed(TransitionModel):
    """Constant turn rate and speed, non-additive noise, state ``[p_x, p_y,
    speed, heading, yaw rate]``; the straight-line branch below a yaw rate of
    1e-30 is a select.

    ``compat_heading``: the reference's code increments the heading by ``dt
    * heading``, against its own docstring and continuous dynamics; the
    default is the documented model (``heading += dt * yaw rate``), and
    ``compat_heading=True`` gives the reference's (its goldens need it), as
    in the JAX package."""

    dim_state = 5
    dim_noise = 2
    noise_additive = False

    def __init__(self, init_rv, noise_rv, noise_gain=None, dt: float = 0.05,
                 compat_heading: bool = False):
        super().__init__(init_rv, noise_rv, noise_gain)
        self.dt, self.compat_heading = dt, compat_heading

    def dyn_fcn(self, x, q, time):
        dt = self.dt
        _, _, speed, heading, omega = x.unbind(-1)
        q0, q1 = q.unbind(-1)
        straight = omega.abs() < _TINY
        c = speed / torch.where(straight, _TINY, omega)
        heading_rate = heading if self.compat_heading else omega
        tail = [dt * q0, dt * heading_rate + 0.5 * dt ** 2 * q1, dt * q1]
        f_turn = torch.stack([
            c * (torch.sin(heading + omega * dt) - torch.sin(heading))
            + 0.5 * dt ** 2 * torch.cos(heading) * q0,
            c * (-torch.cos(heading + omega * dt) + torch.cos(heading))
            + 0.5 * dt ** 2 * torch.sin(heading) * q0] + tail, dim=-1)
        f_straight = torch.stack([dt * speed * torch.cos(heading),
                                  dt * speed * torch.sin(heading)] + tail, dim=-1)
        return x + torch.where(straight[..., None], f_straight, f_turn)

    def dyn_fcn_cont(self, x, q, time):
        _, _, speed, heading, omega = x.unbind(-1)
        zero = torch.zeros_like(speed)
        return torch.stack([speed * torch.cos(heading), speed * torch.sin(heading), zero, omega,
                            zero], dim=-1)


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
    """Base measurement model; ``state_index`` selects the sub-state the
    measurement function sees (for non-additive noise: the entries of the
    augmented ``[state, noise]``, ``dim_substate + dim_noise`` of them)."""

    dim_substate = 0
    dim_out = 0
    dim_noise = 0
    noise_additive = True

    def __init__(self, noise_rv, dim_state: int, state_index=None):
        self.noise_rv = noise_rv
        self.dim_state = int(dim_state)
        self.state_index = (None if state_index is None else
                            tuple(int(i) for i in np.asarray(state_index).ravel()))
        if (self.state_index is not None and not self.noise_additive
                and len(self.state_index) != self.dim_substate + self.dim_noise):
            # without the check the gather would drop the noise and reuse a
            # state entry in its place
            raise ValueError(
                f"non-additive measurement models gather the AUGMENTED [state; noise] "
                f"vector, so state_index must select dim_substate + dim_noise = "
                f"{self.dim_substate + self.dim_noise} entries; got {len(self.state_index)}")

    @property
    def dim_in(self) -> int:
        """Input dim of the measurement function: the state's, with the
        noise's added for non-additive noise."""
        return self.dim_state if self.noise_additive else self.dim_state + self.dim_noise

    @property
    def device(self) -> torch.device:
        return self.noise_rv.device

    def meas_fcn(self, x, r, time):  # pragma: no cover - interface
        raise NotImplementedError

    def _select(self, x):
        return x if self.state_index is None else x[..., list(self.state_index)]

    def meas_fcn_dx(self, x, r, time):
        """Jacobian of ``meas_fcn`` at sub-states ``x`` (..., dim_substate) and
        noise ``r`` (..., Dr); a non-additive model's is taken with respect to
        ``[x, r]``, as the JAX package's."""
        argnums = (0,) if self.noise_additive else (0, 1)
        return jacobian(lambda v, w: self.meas_fcn(v, w, time), (x, r), argnums)

    def meas_eval(self, x, time):
        """Sub-state selection, then the measurement at zero noise, or, for
        non-additive noise, of the selected augmented input ``[state, r]``."""
        x = self._select(x)
        if self.noise_additive:
            return self.meas_fcn(x, x.new_zeros(x.shape[:-1] + (self.dim_noise,)), time)
        return self.meas_fcn(x[..., :self.dim_substate], x[..., -self.dim_noise:], time)

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

    dim_substate = 1
    dim_out = 1
    dim_noise = 1

    def meas_fcn(self, x, r, time):
        return 0.05 * x ** 2 + r


class UNGMNAMeasurement(MeasurementModel):
    """``z = 0.05 r x^2``, non-additive."""

    dim_substate = 1
    dim_out = 1
    dim_noise = 1
    noise_additive = False

    def meas_fcn(self, x, r, time):
        return 0.05 * r * x ** 2


class Pendulum2DMeasurement(MeasurementModel):
    """``z = sin(angle) + r``."""

    dim_substate = 1
    dim_out = 1
    dim_noise = 1

    def meas_fcn(self, x, r, time):
        return torch.sin(x[..., :1]) + r


class RangeMeasurement(MeasurementModel):
    """Range to a vertically falling body from a radar at horizontal
    distance ``sx`` and height ``sy``."""

    dim_substate = 1
    dim_out = 1
    dim_noise = 1

    def __init__(self, noise_rv, dim_state: int, state_index=None, sx: float = 30.0,
                 sy: float = 30.0):
        super().__init__(noise_rv, dim_state, state_index)
        self.sx, self.sy = sx, sy

    def meas_fcn(self, x, r, time):
        return torch.sqrt(self.sx ** 2 + (x[..., 0] - self.sy) ** 2)[..., None] + r


@functools.lru_cache(maxsize=None)
def _bearing_class(base, num_sensors: int):
    """The :class:`BearingMeasurement` subclass of ``num_sensors`` sensors,
    one per count (as the JAX package keeps it), whose ``dim_out`` and
    ``dim_noise`` are the count."""
    return type(f"BearingMeasurement{num_sensors}", (base,),
                {"dim_out": num_sensors, "dim_noise": num_sensors})


class BearingMeasurement(MeasurementModel):
    """Bearings of the target from S sensors at ``sensor_pos`` (S, 2), one
    ``atan2`` each; by default four sensors at the unit vectors ``(1, 0),
    (0, 1), (-1, 0), (0, -1)``.  An instance is of the subclass of its sensor
    count, ``BearingMeasurement<S>``, whose ``dim_out`` and ``dim_noise`` are
    S."""

    dim_substate = 2

    def __new__(cls, noise_rv, dim_state: int, state_index=None, sensor_pos=None):
        count = 4 if sensor_pos is None else len(sensor_pos)
        return super().__new__(cls if cls.dim_out == count else _bearing_class(cls, count))

    def __init__(self, noise_rv, dim_state: int, state_index=None, sensor_pos=None):
        super().__init__(noise_rv, dim_state, state_index)
        if sensor_pos is None:
            sensor_pos = np.vstack((np.eye(2), -np.eye(2)))
        self.sensor_pos = f64(sensor_pos, noise_rv.device).reshape(self.dim_out, 2)

    def meas_fcn(self, x, r, time):
        dx = x[..., :1] - self.sensor_pos[:, 0]
        dy = x[..., 1:2] - self.sensor_pos[:, 1]
        return torch.atan2(dy, dx) + r


class Radar2DMeasurement(MeasurementModel):
    """Range and bearing from a radar at ``radar_loc``."""

    dim_substate = 2
    dim_out = 2
    dim_noise = 2

    def __init__(self, noise_rv, dim_state: int, state_index=None, radar_loc=None):
        super().__init__(noise_rv, dim_state, state_index)
        self.radar_loc = f64(np.zeros(2) if radar_loc is None else radar_loc, noise_rv.device)

    def meas_fcn(self, x, r, time):
        dx = x[..., 0] - self.radar_loc[0]
        dy = x[..., 1] - self.radar_loc[1]
        return torch.stack([torch.sqrt(dx ** 2 + dy ** 2), torch.atan2(dy, dx)], dim=-1) + r
