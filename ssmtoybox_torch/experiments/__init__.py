"""The reproducible studies of the port (counterparts of the JAX package's
``experiments/`` scripts), each runnable as
``python -m ssmtoybox_torch.experiments.<name> [flags]`` with the JAX
script's flags and defaults plus ``--device {cuda,cpu}``:

- :mod:`.icinco_ungm` — classical vs GPQ Kalman filters on UNGM;
- :mod:`.bsq_ungm` — classical vs GPQ vs BSQ filters and smoothers on UNGM;
- :mod:`.gpq_tracking` — UKF vs GPQKF on reentry tracking;
- :mod:`.bsq_tracking` — BSQ Kalman filters with EMV overrides vs the UKF;
- :mod:`.tpq_ungm` — Student filters on UNGM with glint noise;
- :mod:`.tpq_constant_velocity` — the CV radar glint study;
- :mod:`.gpqd_demo` — GPQ vs GPQ+D transforms, EKF vs EKF-GPQD;
- :mod:`.marginal_ungm` — the marginalized GPQ Kalman filter on UNGM;
- :mod:`.polar2cartesian_mt` — moment transforms against Monte-Carlo truth.

Each module has ``build(args)`` (its models, transforms and filters from the
parsed flags) and ``main(argv=None)``, which simulates the data from seeded
``torch.Generator`` s on the device, runs the bank, prints the tables and
returns them as ``{title: {row: {column: value}}}``.  :mod:`.common` is the
harness.
"""
