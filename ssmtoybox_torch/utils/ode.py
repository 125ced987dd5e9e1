"""Single-step ODE integrators (counterpart of :mod:`ssmtoybox_tpu.utils.ode`).

``func(x, q, time)`` takes states ``x`` (..., D) and noise ``q`` (..., Dq)
and broadcasts over the leading dimensions.
"""
from __future__ import annotations

__all__ = ["ode_euler", "ode_runge_kutta_4"]


def ode_euler(func, x, q, time, dt):
    """Forward-Euler step: ``x + dt * f(x, q, t)``."""
    return x + dt * func(x, q, time)


def ode_runge_kutta_4(func, x, q, time, dt):
    """Classic fourth-order Runge-Kutta step."""
    dt2 = 0.5 * dt
    k1 = func(x, q, time)
    k2 = func(x + dt2 * k1, q, time)
    k3 = func(x + dt2 * k2, q, time)
    k4 = func(x + dt * k3, q, time)
    return x + (dt / 6.0) * (k1 + 2.0 * (k2 + k3) + k4)
