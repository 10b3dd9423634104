"""Callback/logger instantiation from config groups (the port's copy of
msla_tpu/utils/instantiators.py; reference: src/utils/instantiators.py:11-50)."""
from __future__ import annotations

from typing import List

from msla_tpu_torch.config import ConfigNode, instantiate
from msla_tpu_torch.utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)


def instantiate_callbacks(callbacks_cfg) -> List:
    callbacks: List = []
    if not callbacks_cfg:
        return callbacks
    if not isinstance(callbacks_cfg, ConfigNode):
        raise TypeError("Callbacks config must be a ConfigNode!")
    for name, cb_conf in callbacks_cfg.items():
        if isinstance(cb_conf, ConfigNode) and "_target_" in cb_conf:
            log.info(f"Instantiating callback <{cb_conf['_target_']}>")
            callbacks.append(instantiate(cb_conf))
    return callbacks


def instantiate_loggers(logger_cfg) -> List:
    loggers: List = []
    if not logger_cfg:
        return loggers
    if not isinstance(logger_cfg, ConfigNode):
        raise TypeError("Logger config must be a ConfigNode!")
    for name, lg_conf in logger_cfg.items():
        if isinstance(lg_conf, ConfigNode) and "_target_" in lg_conf:
            log.info(f"Instantiating logger <{lg_conf['_target_']}>")
            loggers.append(instantiate(lg_conf))
    return loggers
