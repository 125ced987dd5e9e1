"""The port's study harness (``ssmtoybox_torch/experiments/common.py``)
against the JAX package's (``experiments/common.py``), on the CPU.

Tolerances: ``study_scores`` at 1e-12 relative (the same float64 formulas,
Cholesky solves of 2 x 2 matrices); ``run_filter_bank``'s aggregates at
1e-12 relative, ``diverged`` equal; the printed table to the JAX table's 4
decimals; the ``engine`` column equal to the JAX package's ``dd_check``
verdicts.
"""
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssmtoybox_torch import set_device
from ssmtoybox_torch.experiments import common

from torch_experiments_bridge import TINY, port_study, run_jax_script
from experiments import common as jcommon


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port runs on the card unless told otherwise; these tests run it
    on the CPU, on one intra-op thread (the suite runs several workers at
    once)."""
    set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    set_device(None)


def _batch(seed=0, d=2, n=6, m=5):
    """A seeded (D, N, M) truth, (M, D, N) means and (M, D, D, N) covariances:
    run 2 diverges at step 3 (NaN mean), run 1 keeps a finite mean with a
    NaN covariance (lost positive definiteness)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((d, n, m))
    fm = np.moveaxis(x, -1, 0) + 0.1 * rng.standard_normal((m, d, n))
    a = rng.standard_normal((m, d, d, n))
    fP = np.einsum("mijn,mkjn->mikn", a, a) + 0.5 * np.eye(d)[None, :, :, None]
    fm[2, :, 3:] = np.nan
    fP[1] = np.nan
    return x, fm, fP


def test_study_scores_match_jax():
    """Per-run RMSE, NCI, INC and NLL of a batch with a diverged run and a
    run that lost positive definiteness, against the JAX harness, 1e-12;
    the diverged runs' scores are not finite in both, the others' are."""
    x, fm, fP = _batch()
    want = jcommon.study_scores(jnp.asarray(x), jnp.asarray(fm), jnp.asarray(fP))
    got = common.study_scores(torch.as_tensor(x), torch.as_tensor(fm), torch.as_tensor(fP),
                              chunk=2)
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w), err_msg=k)
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, equal_nan=True, err_msg=k)
    assert np.isfinite(got["nci"].numpy()[[0, 3, 4]]).all()


class _Result:
    def __init__(self, fi_mean, fi_cov):
        self.fi_mean, self.fi_cov = fi_mean, fi_cov


class _Alg:
    """A filter that returns fixed moments, in either package's arrays."""

    def __init__(self, fm, fP, wrap):
        self._res = _Result(wrap(fm), wrap(fP))

    def forward_pass_batch(self, ys):
        return self._res


def _banks():
    x, fm, fP = _batch(1)
    y = x[:1]
    algs = {"fake": (fm, fP), "clean": (fm[[0, 3, 4]], fP[[0, 3, 4]])}
    xs = {"fake": x, "clean": x[..., [0, 3, 4]]}
    jax_rows = {name: jcommon.run_filter_bank({name: _Alg(*a, jnp.asarray)}, y[..., :len(a[0])],
                                              xs[name], verbose=False, warmup=False)[0]
                for name, a in algs.items()}
    port_rows = {name: common.run_filter_bank({name: _Alg(*a, torch.as_tensor)},
                                              torch.as_tensor(y[..., :len(a[0])]),
                                              torch.as_tensor(xs[name]), verbose=False,
                                              warmup=False)[0]
                 for name, a in algs.items()}
    return port_rows, jax_rows


def test_run_filter_bank_matches_jax():
    """Every aggregate and ``diverged`` of the port's harness equal the JAX
    harness's on fake filters: a bank with a diverged run and a run with a
    finite mean but a NaN covariance (both left out of the means), and a
    clean one."""
    port_rows, jax_rows = _banks()
    for name, df in jax_rows.items():
        row, jrow = port_rows[name][name], df.loc[name]
        assert sorted(row) == sorted(jrow.index)
        assert row["diverged"] == int(jrow["diverged"]) == (2 if name == "fake" else 0)
        for k in row:
            if k not in ("diverged", "wallclock_s"):
                np.testing.assert_allclose(row[k], float(jrow[k]), rtol=1e-12, err_msg=k)


def test_print_tables_matches_jax_dataframe(capsys):
    """The printed table has the JAX table's rows and columns, each value to
    its 4 decimals; ``columns`` picks and orders them; ``latex=True`` adds a
    ``tabular`` with the same cells."""
    port_rows, jax_rows = _banks()
    rows = {name: r[name] for name, r in port_rows.items()}
    cols = ["rmse", "rmse_2std", "nci", "nll", "diverged"]
    common.print_tables(rows, "bank", latex=True, columns=cols)
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "===== bank ====="
    assert out[2].split() == cols
    for line, (name, df) in zip(out[3:5], jax_rows.items()):
        cells = line.split()
        assert cells[0] == name
        want = [f"{float(df.loc[name][c]):.4f}" if c != "diverged" else str(int(df.loc[name][c]))
                for c in cols]
        assert cells[1:] == want
    tex = [ln for ln in out if ln.startswith(("fake &", "clean &"))]
    assert [re.split(r" & | \\\\", t)[1:-1] for t in tex] == [ln.split()[1:] for ln in out[3:5]]


def test_save_load_round_trip(tmp_path):
    """Tensors and arrays saved to an ``.npz`` come back as the same arrays;
    a missing file loads as None."""
    path = str(tmp_path / "study.npz")
    fm = torch.arange(6.0, dtype=torch.float64).reshape(2, 3)
    common.save_results(path, fm=fm, rmse=np.array([1.0, 2.0]))
    out = common.load_results(path)
    np.testing.assert_array_equal(out["fm"], fm.numpy())
    np.testing.assert_array_equal(out["rmse"], [1.0, 2.0])
    assert common.load_results(str(tmp_path / "missing.npz")) is None


@pytest.mark.parametrize("name", ["icinco_ungm", "gpq_tracking"])
def test_engine_column_matches_jax_dd_check(monkeypatch, name):
    """Under ``--engine dd`` each filter's ``engine`` column is ``dd`` where
    the JAX package's ``dd_check`` accepts its configuration, ``f64`` where
    it refuses (the port's check is :func:`ssmtoybox_torch.ops.dd_check`)."""
    from ssmtoybox_tpu.ops.ddvec import dd_supports

    argv = [*TINY[name], "--engine", "dd"]
    rec = run_jax_script(monkeypatch, name, argv)
    _, port = port_study(name, argv)
    rows, _ = common.run_filter_bank(port.algs, torch.as_tensor(rec["y"]),
                                     torch.as_tensor(rec["x"]), verbose=False, warmup=False,
                                     engine="dd")
    want = {n: "dd" if dd_supports(a.mod_dyn, a.mod_obs, a.tf_dyn, a.tf_obs) else "f64"
            for n, a in rec["algs"].items()}
    assert {n: r["engine"] for n, r in rows.items()} == want


def test_dd_check_raises_with_the_reason(capsys):
    """``dd_check`` passes what the fused kernels take and raises a
    ``ValueError`` naming the reason otherwise; ``run_filter_bank`` then
    runs that filter in float64 and says so on stderr."""
    from ssmtoybox_torch import ssinf
    from ssmtoybox_torch.ops import dd_check

    _, b = port_study("icinco_ungm", TINY["icinco_ungm"])
    ukf = b.algs["UKF"]
    dd_check(ukf.mod_dyn, ukf.mod_obs, ukf.tf_dyn, ukf.tf_obs)
    par = np.array([[1.0, 3.0]])
    tpq = ssinf.StudentProcessKalman(b.dyn, b.obs, par, par)
    with pytest.raises(ValueError, match="TPQ"):
        dd_check(tpq.mod_dyn, tpq.mod_obs, tpq.tf_dyn, tpq.tf_obs)
    x = b.dyn.simulate_discrete(torch.Generator().manual_seed(0), steps=5, mc_sims=3)
    y = b.obs.simulate_measurements(torch.Generator().manual_seed(1), x)
    rows, _ = common.run_filter_bank({"TPQKF": tpq, "UKF": ukf}, y, x, verbose=False,
                                     warmup=False, engine="dd")
    assert {n: r["engine"] for n, r in rows.items()} == {"TPQKF": "f64", "UKF": "dd"}
    assert "TPQKF: engine='dd' unsupported (" in capsys.readouterr().err


def test_studies_need_no_pandas(monkeypatch, capsys):
    """With pandas unimportable, two studies run end to end on the CPU at
    tiny sizes (the classical-vs-GPQ bank through the fused engine's plain
    version, and the transform tables), print their tables and return them."""
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    from ssmtoybox_torch.experiments import icinco_ungm, polar2cartesian_mt

    tables = icinco_ungm.main(["--device", "cpu", "--mc", "4", "--steps", "10",
                               "--engine", "dd"])
    (rows,) = tables.values()
    assert list(rows) == ["UKF", "CKF", "GHKF-5", "GPQKF-SR", "GPQKF-UT", "GPQKF-GH5",
                          "GPQKF-GH7"]
    assert {r["engine"] for r in rows.values()} == {"dd"}
    assert all(np.isfinite(r["rmse"]) for r in rows.values())
    tables = polar2cartesian_mt.main(["--device", "cpu", "--mc", "2000"])
    assert [len(t) for t in tables.values()] == [7, 4]
    assert "===== truncated UT vs UT, growing irrelevant dims =====" in capsys.readouterr().out


def test_card_is_asked_for_by_default(monkeypatch):
    """Without a card a study asked for the default ``--device cuda`` raises
    the port's no-card error; it does not fall back to the CPU."""
    from ssmtoybox_torch.experiments import icinco_ungm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="set_device"):
        icinco_ungm.main(["--mc", "2", "--steps", "3"])
