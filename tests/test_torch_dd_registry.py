"""Models registered at run time in the port's fused filter kernels: the
counterpart of the JAX package's dd registries (``ops/ddfilter.py``
``register_dyn_dd`` / ``register_obs_dd``, ``ops/ddvec.py``
``register_dyn_dd_vec`` / ``register_obs_dd_vec``).

Each test model exists twice, a port class registered with a
:class:`~ssmtoybox_torch.ops.KernelForm` and a JAX class registered with a
double-double evaluator (never run here: no JAX dd program is compiled), and
both are unregistered when the module ends:

- ``growth``: a 1-D transition with a per-step stream and a 1-D measurement,
  through the scalar API (the scalar filter kernel's registered form); each
  also beside the kernel's own UNGM measurement or transition
  (``growth_ungm``, ``ungm_sat``);
- ``osc``: a 2-D transition with a stream and a 2-output measurement of the
  components its ``state_index`` picks (the registered vector kernel);
- ``osc_sat``: the same transition with the 1-D measurement of the scalar
  registry read on component 1 of the state (``ddvec._obs_lower_for``'s
  adaptation);
- ``chain``: an 8-D transition with the table's radar at a ``state_index``;
- ``pend``: a subclass of ``Pendulum2DTransition`` registered with the
  statements of ``VfDyn<VF_DYN_PENDULUM>``, with the radar.

The tests hold (a) admission: ``ops.dd_check`` / ``vector_filter.supports`` /
``scalar_filter.supports`` against ``ddvec.dd_supports`` /
``ddfilter.supports`` under the same registrations, a subclass of a
scalar-registered class refused by both (exact type) and of a
vector-registered one admitted by both (MRO); (b) all five moment streams of
``engine="dd"`` on the CPU (the forms' plain versions) against the JAX
package's float64 ``gaussian_filter_batch`` on the same numpy-seeded
measurements, at 1e-10 (classical rules) and 1e-8 (BQ), the tolerances of
``tests/test_torch_dd_pairs.py``; (c) the g++ build of the generated source
(``vector_filter_host.cpp`` / ``scalar_filter_host.cpp`` with the generated
header, one build a module) against the plain version to the bit, both with
the C library's transcendentals; (d) the pendulum copy equal to the bit to
the table's pendulum in the general step.
"""
import math
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu import ssmod as jssmod
from ssmtoybox_tpu.ops import ddfilter, ddvec
from ssmtoybox_tpu.ops import ddmath as dd
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import set_device, ssmod
from ssmtoybox_torch.ops import (KernelForm, dd_check, forms, register_dyn_dd,
                                 register_dyn_dd_vec, register_obs_dd, register_obs_dd_vec,
                                 scalar_filter as sf, vector_filter as vf)
from ssmtoybox_torch.utils import GaussRV


def _libm(fn):
    def apply(*ts):
        flat = [t.reshape(-1).tolist() for t in ts]
        out = torch.tensor([fn(*v) for v in zip(*flat)], dtype=torch.float64)
        return out.reshape(ts[0].shape)
    return apply


#: the C library's transcendentals, one value at a time: what a g++ build of
#: the kernels' headers calls (PyTorch's vectorised CPU versions may be an ulp off)
LIBM_FNS = SimpleNamespace(
    sqrt=_libm(lambda v: math.sqrt(v) if v >= 0.0 or v != v else math.nan),
    exp=_libm(lambda v: math.exp(v) if v < 709.0 or v != v else math.inf),
    sin=_libm(math.sin), cos=_libm(math.cos), atan2=_libm(math.atan2))

FIELDS = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")
B, T = 4, 20


# ---------------------------------------------------------------------------
# the test models, in both packages
# ---------------------------------------------------------------------------

class Growth1D(ssmod.TransitionModel):
    """``a x + b x / (1 + x^2) + 2 cos(0.7 t) + q``."""
    dim_state, dim_noise = 1, 1
    A, B = 0.5, 5.0

    def dyn_fcn(self, x, q, time):
        return self.A * x + self.B * (x / (1.0 + x * x)) + 2.0 * math.cos(0.7 * time) + q


class JGrowth1D(jssmod.TransitionModel):
    dim_state, dim_noise = 1, 1
    A, B = Growth1D.A, Growth1D.B

    def dyn_fcn(self, x, q, time):
        return self.A * x + self.B * (x / (1.0 + x * x)) + 2.0 * jnp.cos(0.7 * time) + q


class Sat1D(ssmod.MeasurementModel):
    """``x + 0.5 sin(x) + r`` of one state component."""
    dim_substate, dim_out, dim_noise = 1, 1, 1
    C = (1.0, 0.5)

    def meas_fcn(self, x, r, time):
        return self.C[0] * x + self.C[1] * torch.sin(x) + r


class JSat1D(jssmod.MeasurementModel):
    dim_substate, dim_out, dim_noise = 1, 1, 1
    C = Sat1D.C

    def meas_fcn(self, x, r, time):
        return self.C[0] * x + self.C[1] * jnp.sin(x) + r


class Osc2D(ssmod.TransitionModel):
    """A driven pendulum: ``[x0 + dt x1, x1 - w dt sin(x0) + dt u_t]``, ``u_t =
    0.5 sin(0.1 t)``."""
    dim_state, dim_noise = 2, 2
    DT, W = 0.05, 4.0

    def dyn_fcn(self, x, q, time):
        x0, x1 = x.unbind(-1)
        u = 0.5 * math.sin(0.1 * time)
        return torch.stack([x0 + self.DT * x1,
                            x1 - (self.W * self.DT) * torch.sin(x0) + self.DT * u], -1) + q


class JOsc2D(jssmod.TransitionModel):
    dim_state, dim_noise = 2, 2
    DT, W = Osc2D.DT, Osc2D.W

    def dyn_fcn(self, x, q, time):
        u = 0.5 * jnp.sin(0.1 * time)
        return jnp.stack([x[0] + self.DT * x[1],
                          x[1] - (self.W * self.DT) * jnp.sin(x[0]) + self.DT * u]) + q


class Mix2(ssmod.MeasurementModel):
    """``[a^2 + 0.5 b, sin(b) + 0.2 a]`` of the components (a, b) its
    ``state_index`` picks."""
    dim_substate, dim_out, dim_noise = 2, 2, 2

    def meas_fcn(self, x, r, time):
        a, b = x[..., 0], x[..., 1]
        return torch.stack([a * a + 0.5 * b, torch.sin(b) + 0.2 * a], -1) + r


class JMix2(jssmod.MeasurementModel):
    dim_substate, dim_out, dim_noise = 2, 2, 2

    def meas_fcn(self, x, r, time):
        return jnp.stack([x[0] * x[0] + 0.5 * x[1], jnp.sin(x[1]) + 0.2 * x[0]]) + r


class Chain8D(ssmod.TransitionModel):
    """Four coupled pendulums, state ``[p0, v0, ..., p3, v3]``:
    ``p_i + dt v_i``, ``v_i - dt (w sin(p_i) - k (p_(i+1) - p_i))``."""
    dim_state, dim_noise = 8, 8
    DT, W, K = 0.05, 2.0, 0.5

    def dyn_fcn(self, x, q, time):
        p, v = x[..., 0::2], x[..., 1::2]
        nxt = torch.roll(p, -1, dims=-1)
        f = torch.stack([p + self.DT * v,
                         v - self.DT * (self.W * torch.sin(p) - self.K * (nxt - p))], -1)
        return f.reshape(x.shape) + q


class JChain8D(jssmod.TransitionModel):
    dim_state, dim_noise = 8, 8
    DT, W, K = Chain8D.DT, Chain8D.W, Chain8D.K

    def dyn_fcn(self, x, q, time):
        p, v = x[0::2], x[1::2]
        nxt = jnp.roll(p, -1)
        f = jnp.stack([p + self.DT * v,
                       v - self.DT * (self.W * jnp.sin(p) - self.K * (nxt - p))], -1)
        return f.reshape(x.shape) + q


class PendCopy(ssmod.Pendulum2DTransition):
    """The table's pendulum, registered with the statements of its form."""


class JPendCopy(jssmod.Pendulum2DTransition):
    pass


class SubGrowth(Growth1D):
    """No registration of its own: the scalar registry finds none (exact type)."""


class JSubGrowth(JGrowth1D):
    pass


class SubOsc(Osc2D):
    """No registration of its own: the vector registry finds its base's (MRO)."""


class JSubOsc(JOsc2D):
    pass


# ---------------------------------------------------------------------------
# the port's kernel forms
# ---------------------------------------------------------------------------

def _growth_plain(x, c, s, fns):
    return c[0] * x + c[1] * (x / (1.0 + x * x)) + s[0]


GROWTH_FORM = KernelForm("f[0] = c[0] * x[0] + c[1] * (x[0] / (1.0 + x[0] * x[0])) + s[0];",
                         (Growth1D.A, Growth1D.B), _growth_plain)


def _growth_stream(model, n_steps):
    return 2.0 * np.cos(0.7 * np.arange(n_steps))


def _sat_plain(x, c, fns):
    return c[0] * x + c[1] * fns.sin(x)


SAT_FORM = KernelForm("h[0] = c[0] * x[0] + c[1] * sin(x[0]);", Sat1D.C, _sat_plain)


def _osc_lower(model, n_steps):
    def plain(x, c, s, fns):
        x0, x1 = x.unbind(-1)
        return torch.stack([x0 + c[0] * x1, x1 - c[1] * fns.sin(x0) + c[0] * s[0]], -1)
    form = KernelForm("f[0] = x[0] + c[0] * x[1];\n"
                      "f[1] = x[1] - c[1] * sin(x[0]) + c[0] * s[0];",
                      (model.DT, model.W * model.DT), plain)
    return [0.5 * np.sin(0.1 * np.arange(n_steps))], form


def _mix_lower(model):
    i, j = model.state_index or (0, 1)

    def plain(x, c, fns):
        a, b = x[..., i], x[..., j]
        return torch.stack([a * a + c[0] * b, fns.sin(b) + c[1] * a], -1)
    return KernelForm(f"h[0] = x[{i}] * x[{i}] + c[0] * x[{j}];\n"
                      f"h[1] = sin(x[{j}]) + c[1] * x[{i}];", (0.5, 0.2), plain)


def _chain_lower(model, n_steps):
    lines = []
    for i in range(4):
        p, v, nxt = 2 * i, 2 * i + 1, 2 * ((i + 1) % 4)
        lines += [f"f[{p}] = x[{p}] + c[0] * x[{v}];",
                  f"f[{v}] = x[{v}] - c[0] * (c[1] * sin(x[{p}]) - c[2] * (x[{nxt}] - x[{p}]));"]

    def plain(x, c, s, fns):
        p, v = x[..., 0::2], x[..., 1::2]
        nxt = torch.roll(p, -1, dims=-1)
        f = torch.stack([p + c[0] * v, v - c[0] * (c[1] * fns.sin(p) - c[2] * (nxt - p))], -1)
        return f.reshape(x.shape)
    return [], KernelForm("\n".join(lines), (model.DT, model.W, model.K), plain)


def _pend_lower(model, n_steps):
    def plain(x, c, s, fns):
        x0, x1 = x.unbind(-1)
        return torch.stack([x0 + x1 * c[0], x1 - c[1] * fns.sin(x0)], -1)
    return [], KernelForm("f[0] = x[0] + x[1] * c[0];\nf[1] = x[1] - c[1] * sin(x[0]);",
                          (model.dt, model.g * model.dt), plain)


# ---------------------------------------------------------------------------
# the JAX package's evaluators (registered for admission; never run here)
# ---------------------------------------------------------------------------

def _j_growth(model, x, c):
    frac = dd.div(x, dd.add_f(dd.sqr(x), np.float32(1.0)))
    return dd.add(dd.add(dd.mul(dd.const(model.A), x), dd.mul(dd.const(model.B), frac)), c)


def _j_sat(model, x):
    return dd.add(dd.mul(dd.const(model.C[0]), x), dd.mul(dd.const(model.C[1]), dd.sincos(x)[0]))


def _j_osc(model, n_steps):
    dt, wdt = dd.const(model.DT), dd.const(model.W * model.DT)

    def eval_dd(x, c):
        return [dd.add(x[0], dd.mul(dt, x[1])),
                dd.add(dd.sub(x[1], dd.mul(wdt, dd.sincos(x[0])[0])), dd.mul(dt, c[0]))]
    return [0.5 * np.sin(0.1 * np.arange(n_steps))], eval_dd


def _j_mix(model):
    i, j = model.state_index or (0, 1)

    def eval_dd(x):
        return [dd.add(dd.sqr(x[i]), dd.mul(dd.const(0.5), x[j])),
                dd.add(dd.sincos(x[j])[0], dd.mul(dd.const(0.2), x[i]))]
    return eval_dd


def _j_chain(model, n_steps):
    dt, w, k = dd.const(model.DT), dd.const(model.W), dd.const(model.K)

    def eval_dd(x, c):
        out = []
        for i in range(4):
            p, v, nxt = x[2 * i], x[2 * i + 1], x[2 * ((i + 1) % 4)]
            acc = dd.sub(dd.mul(w, dd.sincos(p)[0]), dd.mul(k, dd.sub(nxt, p)))
            out += [dd.add(p, dd.mul(dt, v)), dd.sub(v, dd.mul(dt, acc))]
        return out
    return [], eval_dd


#: (port registry, JAX registry, class, entry) of every registration
REGISTRATIONS = [
    (forms.DYN_DD, ddfilter._DYN_DD, (Growth1D, JGrowth1D),
     ((_growth_stream, GROWTH_FORM), (_growth_stream, _j_growth))),
    (forms.OBS_DD, ddfilter._OBS_DD, (Sat1D, JSat1D), (SAT_FORM, _j_sat)),
    (forms.DYN_DD_VEC, ddvec._DYN_DD_VEC, (Osc2D, JOsc2D), (_osc_lower, _j_osc)),
    (forms.OBS_DD_VEC, ddvec._OBS_DD_VEC, (Mix2, JMix2), (_mix_lower, _j_mix)),
    (forms.DYN_DD_VEC, ddvec._DYN_DD_VEC, (Chain8D, JChain8D), (_chain_lower, _j_chain)),
    (forms.DYN_DD_VEC, ddvec._DYN_DD_VEC, (PendCopy, JPendCopy),
     (_pend_lower, ddvec._pendulum_lower)),
]


@pytest.fixture(autouse=True, scope="module")
def _registered_on_cpu():
    """Register every test model in both packages (the port's through its
    public functions) and unregister them when the module ends: the
    registries are module globals, and other test files run in the same
    process.  The port runs on the CPU, on one intra-op thread."""
    set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    register_dyn_dd(Growth1D, _growth_stream, GROWTH_FORM)
    register_obs_dd(Sat1D, SAT_FORM)
    register_dyn_dd_vec(Osc2D, _osc_lower)
    register_obs_dd_vec(Mix2, _mix_lower)
    register_dyn_dd_vec(Chain8D, _chain_lower)
    register_dyn_dd_vec(PendCopy, _pend_lower)
    ddfilter.register_dyn_dd(JGrowth1D, _growth_stream, _j_growth)
    ddfilter.register_obs_dd(JSat1D, _j_sat)
    for cls, lower in ((JOsc2D, _j_osc), (JChain8D, _j_chain), (JPendCopy, ddvec._pendulum_lower)):
        ddvec.register_dyn_dd_vec(cls, lower)
    ddvec.register_obs_dd_vec(JMix2, _j_mix)
    yield
    for port, jax_reg, (cls, jcls), _ in REGISTRATIONS:
        port.pop(cls, None)
        jax_reg.pop(jcls, None)
    torch.set_num_threads(threads)
    set_device(None)


CT_RADAR_R = np.diag([0.01, 1e-3])

#: system -> maker(pkg): (transition, measurement) in the port (pkg "port")
#: or the JAX package (pkg "jax")
SYSTEMS = {
    "growth": lambda new, rv: (new(Growth1D, JGrowth1D)(rv(1, np.zeros(1), np.eye(1)),
                                                        rv(1, None, np.eye(1))),
                               new(Sat1D, JSat1D)(rv(1, None, 0.1 * np.eye(1)), dim_state=1)),
    "growth_ungm": lambda new, rv: (
        new(Growth1D, JGrowth1D)(rv(1, np.zeros(1), np.eye(1)), rv(1, None, np.eye(1))),
        new(ssmod.UNGMMeasurement, jssmod.UNGMMeasurement)(rv(1, None, np.eye(1)), dim_state=1)),
    "ungm_sat": lambda new, rv: (
        new(ssmod.UNGMTransition, jssmod.UNGMTransition)(rv(1, None, 5.0 * np.eye(1)),
                                                         rv(1, None, 10.0 * np.eye(1))),
        new(Sat1D, JSat1D)(rv(1, None, 0.1 * np.eye(1)), dim_state=1)),
    "osc": lambda new, rv: (new(Osc2D, JOsc2D)(rv(2, np.array([1.0, 0.0]), 0.1 * np.eye(2)),
                                               rv(2, None, 1e-3 * np.eye(2))),
                            new(Mix2, JMix2)(rv(2, None, 0.05 * np.eye(2)), dim_state=2,
                                             state_index=[1, 0])),
    "osc_sat": lambda new, rv: (new(Osc2D, JOsc2D)(rv(2, np.array([1.0, 0.0]), 0.1 * np.eye(2)),
                                                   rv(2, None, 1e-3 * np.eye(2))),
                                new(Sat1D, JSat1D)(rv(1, None, 0.01 * np.eye(1)), dim_state=2,
                                                   state_index=[1])),
    "chain": lambda new, rv: (new(Chain8D, JChain8D)(
                                  rv(8, np.tile([0.5, 0.0], 4), 0.05 * np.eye(8)),
                                  rv(8, None, 1e-4 * np.eye(8))),
                              new(ssmod.Radar2DMeasurement, jssmod.Radar2DMeasurement)(
                                  rv(2, None, CT_RADAR_R), dim_state=8, state_index=[0, 2],
                                  radar_loc=np.array([-3.0, -3.0]))),
    "pend": lambda new, rv: (new(PendCopy, JPendCopy)(rv(2, np.array([1.5, 0.0]),
                                                         0.01 * np.eye(2)),
                                                      rv(2, None, 1e-4 * np.eye(2)), dt=0.01),
                             new(ssmod.Radar2DMeasurement, jssmod.Radar2DMeasurement)(
                                 rv(2, None, CT_RADAR_R), dim_state=2, state_index=[0, 1],
                                 radar_loc=np.array([-2.0, -2.0]))),
    "pend_table": lambda new, rv: (new(ssmod.Pendulum2DTransition, jssmod.Pendulum2DTransition)(
                                       rv(2, np.array([1.5, 0.0]), 0.01 * np.eye(2)),
                                       rv(2, None, 1e-4 * np.eye(2)), dt=0.01),
                                   new(ssmod.Radar2DMeasurement, jssmod.Radar2DMeasurement)(
                                       rv(2, None, CT_RADAR_R), dim_state=2, state_index=[0, 1],
                                       radar_loc=np.array([-2.0, -2.0]))),
}


def _system(name, jax_side=False):
    if jax_side:
        new, rv = (lambda c, jc: jc.create), (lambda d, m, c: JGaussRV.create(d, mean=m, cov=c))
    else:
        new, rv = (lambda c, jc: c), (lambda d, m, c: GaussRV(d, mean=m, cov=c))
    return SYSTEMS[name](new, rv)


def _kpar(D):
    return np.array([[1.0] + [3.0] * D])


#: rule -> (maker in the port, maker in the JAX package)
RULES = {
    "ukf": (lambda d, o: stt.UnscentedKalman(d, o), lambda d, o: st.UnscentedKalman(d, o)),
    "ckf": (lambda d, o: stt.CubatureKalman(d, o), lambda d, o: st.CubatureKalman(d, o)),
    "gh9": (lambda d, o: stt.GaussHermiteKalman(d, o, deg=9),
            lambda d, o: st.GaussHermiteKalman(d, o, deg=9)),
    "gpq": (lambda d, o: stt.GaussianProcessKalman(d, o, _kpar(d.dim_state), _kpar(d.dim_state)),
            lambda d, o: st.GaussianProcessKalman(d, o, _kpar(d.dim_state), _kpar(d.dim_state),
                                                  points="ut")),
}


def _filter(system, rule, jax_side=False):
    return RULES[rule][int(jax_side)](*_system(system, jax_side))


def _simulate(system, seed=0):
    """(B, E, T) measurements simulated with numpy noise through the port's
    model functions (truth from step 0, measurement k of the state at step
    k)."""
    d, o = _system(system)
    rng = np.random.default_rng(seed)
    m0, P0 = (t.numpy() for t in d.init_rv.get_stats()[:2])
    Q, R = d.noise_rv.get_stats()[1].numpy(), o.noise_rv.get_stats()[1].numpy()
    D = d.dim_state
    x = torch.as_tensor(rng.multivariate_normal(np.ravel(m0), np.reshape(P0, (D, D)), size=B))
    ys = []
    for k in range(T):
        q = rng.multivariate_normal(np.zeros(len(Q)), np.atleast_2d(Q), size=B)
        x = d.dyn_fcn(x, torch.as_tensor(q), k)
        r = torch.as_tensor(rng.multivariate_normal(np.zeros(len(R)), np.atleast_2d(R), size=B))
        ys.append(o.meas_fcn(o._select(x), r, k + 1))
    return torch.stack(ys, dim=-1)


def _tol(rule):
    return 1e-8 if rule == "gpq" else 1e-10


# ---------------------------------------------------------------------------
# (a) admission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("system", ["growth", "growth_ungm", "ungm_sat", "osc", "osc_sat",
                                    "chain", "pend"])
def test_registered_models_are_admitted_by_both(system):
    """Every registered configuration: ``dd_supports`` and ``ops.dd_check``
    agree (both admit), and the port routes it to a registered kernel."""
    alg, jalg = _filter(system, "ukf"), _filter(system, "ukf", jax_side=True)
    assert ddvec.dd_supports(jalg.mod_dyn, jalg.mod_obs, jalg.tf_dyn, jalg.tf_obs)
    dd_check(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    if alg.mod_dyn.dim_state == 1:
        params = sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
        assert sf.form_of(params) == "registered"
        assert sf.supports(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
        assert ddfilter.supports(jalg.mod_dyn, jalg.mod_obs, jalg.tf_dyn, jalg.tf_obs)
    else:
        params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
        assert vf.kernel_of(params) == "vector_filter_registered"
        assert vf.supports(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)


def test_a_subclass_of_a_scalar_registered_class_is_refused_by_both():
    """The scalar registry is looked up by exact type in both packages."""
    rv, jrv = GaussRV(1, cov=1.0), JGaussRV.create(1, cov=np.eye(1))
    dyn, obs = SubGrowth(rv, rv), Sat1D(GaussRV(1, cov=0.1), dim_state=1)
    jdyn, jobs = JSubGrowth.create(jrv, jrv), JSat1D.create(jrv, dim_state=1)
    alg, jalg = stt.UnscentedKalman(dyn, obs), st.UnscentedKalman(jdyn, jobs)
    assert not ddvec.dd_supports(jdyn, jobs, jalg.tf_dyn, jalg.tf_obs)
    assert not ddfilter.supports(jdyn, jobs, jalg.tf_dyn, jalg.tf_obs)
    assert not sf.supports(dyn, obs, alg.tf_dyn, alg.tf_obs)
    with pytest.raises(ValueError, match="no kernel form of SubGrowth"):
        dd_check(dyn, obs, alg.tf_dyn, alg.tf_obs)
    with pytest.raises(ValueError, match="engine='dd' cannot run this configuration"):
        alg.forward_pass_batch(torch.zeros((1, 1, 3), dtype=torch.float64), engine="dd")


def test_a_subclass_of_a_vector_registered_class_is_admitted_by_both():
    """The vector registry is looked up through the MRO in both packages:
    the subclass runs its base's form."""
    base = _filter("osc", "ukf")
    dyn = SubOsc(base.mod_dyn.init_rv, base.mod_dyn.noise_rv)
    jbase = _filter("osc", "ukf", jax_side=True)
    jdyn = JSubOsc.create(jbase.mod_dyn.init_rv, jbase.mod_dyn.noise_rv)
    jalg = st.UnscentedKalman(jdyn, jbase.mod_obs)
    assert ddvec.dd_supports(jdyn, jbase.mod_obs, jalg.tf_dyn, jalg.tf_obs)
    alg = stt.UnscentedKalman(dyn, base.mod_obs)
    dd_check(dyn, base.mod_obs, alg.tf_dyn, alg.tf_obs)
    sub = vf.prepare(dyn, base.mod_obs, alg.tf_dyn, alg.tf_obs)
    own = vf.prepare(base.mod_dyn, base.mod_obs, base.tf_dyn, base.tf_obs)
    assert sub.dyn_form == own.dyn_form and sub.n_s == own.n_s == 1


def test_the_registry_api_is_exported():
    import ssmtoybox_torch.ops as ops
    for name in ("register_dyn_dd_vec", "register_obs_dd_vec", "register_dyn_dd",
                 "register_obs_dd", "KernelForm"):
        assert name in ops.__all__ and callable(getattr(ops, name))
    with pytest.raises(ValueError, match="plain PyTorch version"):
        KernelForm("f[0] = x[0];", ())
    with pytest.raises(ValueError, match="non-empty str"):
        KernelForm("  ", (), _growth_plain)


def test_a_registration_replaces_the_last_one():
    """Registering a class again takes effect at the next ``prepare``: the
    new form, a library of its own and its results; the old registration
    comes back the same way."""
    alg, ys = _filter("osc", "ukf"), _simulate("osc")
    before = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)

    def doubled(model, n_steps):
        streams, form = _osc_lower(model, n_steps)
        return [2.0 * streams[0]], form

    try:
        register_dyn_dd_vec(Osc2D, doubled)
        after = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
        assert after.dyn_form == before.dyn_form and vf._key(after) == vf._key(before)
        assert not np.array_equal(after.streams(T), before.streams(T))
        a, b = alg.forward_pass_batch(ys, engine="dd"), vf._vector_filter_plain(before, ys)
        assert not torch.equal(a.fi_mean, b[0].permute(2, 1, 0))
        register_dyn_dd_vec(Osc2D, lambda m, n: ([_osc_lower(m, n)[0][0]], KernelForm(
            "f[0] = x[0] + c[0] * x[1];\nf[1] = x[1] - c[1] * sin(x[0]) + c[0] * s[0] * 1.0;",
            _osc_lower(m, n)[1].consts, _osc_lower(m, n)[1].plain)))
        third = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
        assert third.dyn_form != before.dyn_form and vf._key(third) != vf._key(before)
    finally:
        register_dyn_dd_vec(Osc2D, _osc_lower)
    again = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    assert again == before and np.array_equal(again.streams(T), before.streams(T))


# ---------------------------------------------------------------------------
# (b) against the JAX package's float64 filter
# ---------------------------------------------------------------------------

JAX_CASES = [("growth", "ukf"), ("growth", "gh9"), ("growth", "gpq"), ("osc", "ukf"),
             ("osc", "gpq"), ("osc_sat", "ckf"), ("chain", "ckf"), ("pend", "ukf")]


@pytest.mark.parametrize("case", JAX_CASES, ids="-".join)
def test_registered_models_match_jax_f64(case):
    """``engine="dd"`` on the CPU (the forms' plain versions) against the
    JAX package's float64 filter on the same measurements, all five
    streams."""
    system, rule = case
    ys = _simulate(system)
    jalg = _filter(system, rule, jax_side=True)
    ref = jax.jit(lambda b: st.gaussian_filter_batch(jalg.mod_dyn, jalg.mod_obs, jalg.tf_dyn,
                                                     jalg.tf_obs, b))(jnp.asarray(ys.numpy()))
    res = _filter(system, rule).forward_pass_batch(ys, engine="dd")
    for f in FIELDS:
        got = getattr(res, f)
        assert bool(torch.isfinite(got).all()), f
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ref, f)), atol=_tol(rule),
                                   rtol=_tol(rule), err_msg=f)


# ---------------------------------------------------------------------------
# (c) the generated source's host build against the plain version
# ---------------------------------------------------------------------------

HOST_CASES = [("osc", "ukf"), ("osc", "gpq"), ("osc_sat", "ckf"), ("chain", "ckf"),
              ("pend", "ukf"), ("pend", "gh9")]
SCALAR_HOST_CASES = [("growth", "ukf"), ("growth", "gh9"), ("growth", "gpq"),
                     ("growth_ungm", "ukf"), ("ungm_sat", "gh9")]


@pytest.fixture(scope="module")
def host_built():
    """One g++ build of each generated source for every case of the module."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the generated source cannot be built for the host")
    vec = [vf.prepare(a.mod_dyn, a.mod_obs, a.tf_dyn, a.tf_obs)
           for a in (_filter(*c) for c in HOST_CASES)]
    sca = [sf.prepare(a.mod_dyn, a.mod_obs, a.tf_dyn, a.tf_obs)
           for a in (_filter(*c) for c in SCALAR_HOST_CASES)]
    return vf.build_registered(vec, host=True), sf.build_registered(sca, host=True)


@pytest.mark.parametrize("case", HOST_CASES, ids="-".join)
def test_registered_vector_kernel_on_host_matches_plain(host_built, case):
    """``csrc/vector_filter_registered.cu``'s step (the general step on the
    generated model policy) built with g++ == the plain version with the C
    library's transcendentals, to the bit, all five streams; measurements
    read through their strides."""
    alg, ys = _filter(*case), _simulate(case[0], seed=1)
    params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    want = vf._vector_filter_plain(params, ys, LIBM_FNS)
    time_major = ys.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    built = len(vf._build._bound)
    for y in (ys, time_major):
        for a, b in zip(vf._host_shim_run(params, y), want):
            assert bool(torch.isfinite(b).all())
            assert torch.equal(a, b), f"max |diff| {float((a - b).abs().max()):.3e}"
    assert len(vf._build._bound) == built, "the module's build should have held the case"


@pytest.mark.parametrize("case", SCALAR_HOST_CASES, ids="-".join)
def test_registered_scalar_form_on_host_matches_plain(host_built, case):
    """``csrc/scalar_filter_registered.cu``'s step built with g++ == the
    plain version with the C library's square root and sine, to the bit."""
    alg, ys = _filter(*case), _simulate(case[0], seed=2)
    params = sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    c = sf.step_consts(params, T, "cpu")
    assert tuple(c.shape) == ((T,) if case[0] == "ungm_sat" else (T, 1))
    y = ys[:, 0, :].T.contiguous()
    want = sf._scalar_filter_plain(params, y, c, sqrt=LIBM_FNS.sqrt, sin=LIBM_FNS.sin,
                                   fns=LIBM_FNS)
    for yy in (y, ys[:, 0, :].contiguous().T):
        for a, b in zip(sf._host_shim_run(params, yy, c), want):
            assert bool(torch.isfinite(b).all())
            assert torch.equal(a, b), f"max |diff| {float((a - b).abs().max()):.3e}"


def test_generated_headers_hold_only_the_configurations_asked_for(host_built):
    """Each library instantiates the configurations it was built for, once
    each, with D, the bound on E and the lanes a trajectory of each (the
    8-D chain in the lane-group form, its measurement at any E; the 2-D
    configurations at the UT and CKF counts in the shaped one-thread form,
    each with its E, its point count and kinds in its policy)."""
    vec_name, sca_name = host_built
    keys = [k for (host, k) in vf._REGISTERED if host]
    assert {(D, EB, G) for D, EB, G, _ in keys} >= {(2, 2, 0), (8, 0, vf._LANES),
                                                    (2, 2, vf._SHAPED), (2, 1, vf._SHAPED)}
    text = vf._registered_header(list(dict.fromkeys(
        vf._key(vf.prepare(a.mod_dyn, a.mod_obs, a.tf_dyn, a.tf_obs))
        for a in (_filter(*c) for c in HOST_CASES))))
    assert text.count("struct VfrPair") == 6 and f"F(3, 8, 0, {vf._LANES}, VfrPair3)" in text
    assert "F(0, 2, 2, VfrPair0) F(1, 2, 2, VfrPair1) F(2, 2, 1, VfrPair2)" in text
    assert "VfgObsFn<8, 0>" in text and "const double x[1] = {x_state[1]};" in text
    assert vec_name.startswith("vector_filter_registered_host-")
    assert sca_name.startswith("scalar_filter_registered_host-")


# ---------------------------------------------------------------------------
# (d) the pendulum copy against the table's pendulum
# ---------------------------------------------------------------------------

def test_pendulum_copy_equals_the_tables_pendulum_in_the_general_step(host_built):
    """The registered copy of ``VfDyn<VF_DYN_PENDULUM>`` with the radar, in
    the registered kernel's host build, equals the table's pendulum with the
    radar in the general kernel's host build, to the bit, and both their
    plain versions."""
    ys = _simulate("pend", seed=3)
    copy, table = _filter("pend", "ukf"), _filter("pend_table", "ukf")
    p_copy = vf.prepare(copy.mod_dyn, copy.mod_obs, copy.tf_dyn, copy.tf_obs)
    p_table = vf.prepare(table.mod_dyn, table.mod_obs, table.tf_dyn, table.tf_obs)
    assert vf.kernel_of(p_copy) == "vector_filter_registered"
    assert vf.kernel_of(p_table) == "vector_filter_general"
    registered = vf._host_shim_run(p_copy, ys)
    general = vf._host_shim_run(p_table, ys)
    for a, b, c, d in zip(registered, general, vf._vector_filter_plain(p_copy, ys),
                          vf._vector_filter_plain(p_table, ys)):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b) and torch.equal(c, d)


def test_a_generated_source_that_does_not_build_raises_with_the_compilers_output():
    """A form whose statements do not compile: the build of the generated
    source raises with the compiler's output and leaves no library for the
    configuration; the plain version (what the CPU runs) is not the kernel
    and still runs."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the generated source cannot be built for the host")
    alg, ys = _filter("osc", "ukf"), _simulate("osc")

    def broken(model, n_steps):
        streams, form = _osc_lower(model, n_steps)
        return streams, KernelForm("f[0] = x[0] +;\nf[1] = x[1];", form.consts, form.plain)

    try:
        register_dyn_dd_vec(Osc2D, broken)
        params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
        with pytest.raises(RuntimeError, match="building vector_filter_registered_host-.* "
                                               "failed(.|\n)*error"):
            vf.build_registered([params], host=True)
        assert (True, vf._key(params)) not in vf._REGISTERED
        assert bool(torch.isfinite(alg.forward_pass_batch(ys, engine="dd").fi_mean).all())
    finally:
        register_dyn_dd_vec(Osc2D, _osc_lower)


def test_wrappers_on_cpu_run_the_plain_versions_and_count_no_launch():
    """On CPU tensors both wrappers run the forms' plain versions; no launch
    is counted and nothing is built."""
    before = (sf.LAUNCHES, sf.REGISTERED_LAUNCHES, vf.LAUNCHES, vf.REGISTERED_LAUNCHES)
    alg, ys = _filter("chain", "ukf"), _simulate("chain")
    params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    for a, b in zip(vf.vector_filter(params, ys), vf._vector_filter_plain(params, ys)):
        assert torch.equal(a, b)
    alg = _filter("growth", "ukf")
    params = sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    y, c = torch.ones((T, B), dtype=torch.float64), sf.step_consts(params, T, "cpu")
    for a, b in zip(sf.scalar_filter(params, y, c), sf._scalar_filter_plain(params, y, c)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match=r"c \(N, n_s\)"):
        sf.scalar_filter(params, y, c[:, 0])
    assert (sf.LAUNCHES, sf.REGISTERED_LAUNCHES, vf.LAUNCHES, vf.REGISTERED_LAUNCHES) == before


def test_registered_parameter_structs_match_the_headers():
    """The ctypes mirrors of ``VfgParams`` and ``SfrParams`` have the
    headers' fields and the sizes their ``static_assert`` states."""
    import ctypes
    for header, struct, mirror, size in (
            ("vector_filter_general.cuh", "VfgParams", vf._CGParams, 1928),
            ("scalar_filter_step_general.cuh", "SfrParams", sf._CRParams, 184)):
        src = open(f"{vf._build.CSRC}/{header}").read()
        body = src.split(f"struct {struct} {{")[1].split("};")[0]
        for name, _ in mirror._fields_:
            assert f" {name};" in body, (struct, name)
        assert ctypes.sizeof(mirror) == size and f"sizeof({struct}) == {size}" in src
