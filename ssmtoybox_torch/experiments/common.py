"""The harness of the port's study scripts (counterpart of the JAX package's
``experiments/common.py``).

Every Monte-Carlo run of a filter goes through one batched call, and the
RMSE / NCI / INC / NLL scores reduce on the device.  Tables are dicts of
dicts, ``{row: {column: value}}``, printed as fixed-width text (and LaTeX);
nothing here needs pandas.
"""
from __future__ import annotations

import argparse
import inspect
import os
import sys
import time

import numpy as np
import torch

from ..ops import dd_check
from ..utils import metrics as M
from ..utils.arrays import NO_CARD
from ..utils.profiling import sync

__all__ = ["device_of", "parser", "generators", "study_scores", "aggregate",
           "run_filter_bank", "save_results", "load_results", "print_tables"]


def device_of(name: str) -> torch.device:
    """The device a study runs on: ``"cuda"`` (the card; ``RuntimeError``
    without one) or ``"cpu"``.  There is no fallback from one to the other."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)
    return torch.device(name)


def parser(doc: str, seed: int, latex: bool = True) -> argparse.ArgumentParser:
    """The flags every study takes: ``--seed`` (default ``seed``),
    ``--device`` and, unless ``latex=False``, ``--latex``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=seed)
    if latex:
        ap.add_argument("--latex", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the study runs; the card unless 'cpu' is asked for")
    return ap


def generators(dev: torch.device, *seeds: int):
    """One seeded ``torch.Generator`` on ``dev`` a seed."""
    return tuple(torch.Generator(device=dev).manual_seed(int(s)) for s in seeds)


def study_scores(x_true, fi_mean, fi_cov, chunk: int = 1000) -> dict:
    """Time-averaged scores per Monte-Carlo run.

    ``x_true`` (D, N, M) true states, ``fi_mean`` (M, D, N) filtered means,
    ``fi_cov`` (M, D, D, N) filtered covariances.  Returns a dict of (M,)
    tensors: ``rmse``, ``nci``, ``inc``, ``nll``.

    The per-step sample MSE matrix (the NCI / INC normaliser) is taken over
    the runs whose RMSE is finite, plus ``1e-12 I``: one diverged run would
    otherwise make it NaN at every later step and poison the credibility
    scores of every healthy run.  The credibility scores go ``chunk`` runs
    at a time (each run's scores are its own, so chunking changes nothing).
    """
    x = x_true.permute(2, 0, 1)                                    # (M, D, N)
    err = fi_mean - x
    rmse = torch.sqrt(torch.mean(torch.sum(err ** 2, dim=1), dim=-1))
    finite = torch.isfinite(rmse)
    n_ok = torch.clamp(finite.to(err.dtype).sum(), min=1.0)
    err_ok = torch.where(finite[:, None, None], err, 0.0)
    m_runs, d, n = err.shape
    mse = (torch.einsum("mdn,men->nde", err_ok, err_ok) / n_ok
           + 1e-12 * torch.eye(d, dtype=err.dtype, device=err.device))
    xt, mt = x.permute(0, 2, 1), fi_mean.permute(0, 2, 1)           # (M, N, D)
    P = fi_cov.permute(0, 3, 1, 2)                                  # (M, N, D, D)
    lcr, nll = [], []
    for i in range(0, m_runs, chunk):
        s = slice(i, i + chunk)
        lcr.append(M.log_cred_ratio(xt[s], mt[s], P[s], mse.expand(xt[s].shape[0], n, d, d)))
        nll.append(M.neg_log_likelihood(xt[s], mt[s], P[s]))
    lcr, nll = torch.cat(lcr), torch.cat(nll)
    return {"rmse": rmse, "nci": lcr.abs().mean(1), "inc": lcr.mean(1), "nll": nll.mean(1)}


def aggregate(scores: dict, spread: bool = True) -> dict:
    """A table row from per-run scores: each score's mean over the runs
    where EVERY score is finite (a filter can lose positive definiteness on
    a run, NaN in ``nll`` / ``nci`` beside a finite mean) and, with
    ``spread``, twice its standard error (``<score>_2std``); ``diverged``
    counts the runs left out."""
    vals = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float64)
            for k, v in scores.items()}
    m = len(next(iter(vals.values())))
    finite = np.ones(m, dtype=bool)
    for v in vals.values():
        finite &= np.isfinite(v)
    n_ok = max(int(finite.sum()), 1)
    row = {}
    for k, v in vals.items():
        vv = v[finite]
        row[k] = float(np.mean(vv)) if len(vv) else float("nan")
        if spread:
            row[k + "_2std"] = float(2 * np.std(vv) / np.sqrt(n_ok)) if len(vv) else float("nan")
    row["diverged"] = int(m - finite.sum())
    return row


def run_filter_bank(algs: dict, y, x, score_fn=study_scores, verbose: bool = True,
                    warmup: bool = True, engine: str = "f64"):
    """Run every filter over all Monte-Carlo trajectories at once and score it.

    ``y`` / ``x`` are (dim, steps, runs) tensors.  Returns ``(rows, raw)``:
    ``rows[name]`` holds each score's mean over the runs that kept every
    score finite and twice its standard error, ``diverged`` (the runs left
    out) and ``wallclock_s``; ``raw[name]`` is ``(result, scores)``.

    ``warmup=True`` times the second of two calls.  ``engine`` is the
    batch-filter arithmetic of the filters whose ``forward_pass_batch`` takes
    one: ``"f64"`` (default), ``"dd"`` (the fused CUDA kernels) or
    ``"auto"``.  The engine each filter ran lands in the ``engine`` column
    (not under ``"f64"``).  Under ``"dd"``, a filter that the fused engines
    refuse (by :func:`ssmtoybox_torch.ops.dd_check`), or one with no engine
    switch (Student, marginalized, square-root), runs ``"f64"`` with a
    stderr line naming the reason, so a mixed bank still runs; a filter's
    own ``engine="dd"`` still raises on refusal.
    """
    ys = y.permute(2, 0, 1)
    rows, raw = {}, {}

    def resolve_engine(name, alg):
        if engine == "f64":
            return "f64"
        if "engine" not in inspect.signature(alg.forward_pass_batch).parameters:
            if engine == "dd":
                print(f"{name}: engine='dd' unsupported (no engine switch on "
                      f"{type(alg).__name__}.forward_pass_batch); using f64", file=sys.stderr)
            return "f64"
        try:
            dd_check(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
        except ValueError as e:
            if engine == "dd":
                print(f"{name}: engine='dd' unsupported ({e}); using f64", file=sys.stderr)
            return "f64"
        return "dd"

    for name, alg in algs.items():
        used = resolve_engine(name, alg)

        def fwd():
            if used == "f64":
                return alg.forward_pass_batch(ys)
            return alg.forward_pass_batch(ys, engine=used)

        if warmup:
            sync(fwd())
        t0 = time.perf_counter()
        res = fwd()
        sync(res)
        t_run = time.perf_counter() - t0
        scores = score_fn(x, res.fi_mean, res.fi_cov)
        raw[name] = (res, scores)
        row = aggregate(scores)
        row["wallclock_s"] = t_run
        if engine != "f64":
            row["engine"] = used
        rows[name] = row
        if verbose:
            print(f"{name:>12}: done in {t_run:6.3f} s", file=sys.stderr)
    return rows, raw


def save_results(path: str, **arrays):
    """Cache study outputs to an ``.npz`` file (tensors copied to the host)."""
    np.savez_compressed(path, **{k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                                               else v) for k, v in arrays.items()})
    print(f"results saved to {path}", file=sys.stderr)


def load_results(path: str):
    """Reload cached study outputs (a dict of arrays), or None."""
    if not path or not os.path.exists(path):
        return None
    return dict(np.load(path, allow_pickle=False))


def _select(rows: dict, columns) -> dict:
    """The table ``rows`` with ``columns`` only, in that order."""
    return {name: {c: row[c] for c in columns} for name, row in rows.items()}


def _cell(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return f"{float(v):.4f}"
    return str(v)


def _latex(v) -> str:
    return _cell(v).replace("_", r"\_")


def print_tables(rows: dict, title: str, latex: bool = False, columns=None):
    """Print ``rows`` (``{row: {column: value}}``) under ``title`` as a
    fixed-width table, floats to 4 decimals, and as a LaTeX ``tabular``
    with ``latex=True``; ``columns`` picks and orders the columns shown
    (all by default)."""
    if columns is not None:
        rows = _select(rows, columns)
    print(f"\n===== {title} =====")
    cols = list(dict.fromkeys(c for row in rows.values() for c in row))
    cells = [[str(name)] + [_cell(row.get(c, "")) for c in cols] for name, row in rows.items()]
    head = [""] + cols
    width = [max(len(r[j]) for r in cells + [head]) for j in range(len(head))]
    fmt = lambda r: "  ".join(  # noqa: E731
        [r[0].ljust(width[0])] + [v.rjust(w) for v, w in zip(r[1:], width[1:])])
    print(fmt(head))
    for r in cells:
        print(fmt(r))
    if latex:
        print("\\begin{tabular}{l" + "r" * len(cols) + "}")
        print("\\toprule")
        print(" & " + " & ".join(_latex(c) for c in cols) + " \\\\")
        print("\\midrule")
        for name, row in rows.items():
            print(_latex(name) + " & " + " & ".join(_latex(row.get(c, "")) for c in cols)
                  + " \\\\")
        print("\\bottomrule")
        print("\\end{tabular}")
