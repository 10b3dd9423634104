"""The TPE hyper-parameter sweep (the port's copy of msla_tpu/sweep/):
``python -m msla_tpu_torch -m hparams_search=optuna``."""
