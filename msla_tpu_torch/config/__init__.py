"""Hydra-equivalent configuration (the port's copy of msla_tpu/config/).

Composes the repository's configs/ as they are, with the interpolation and
instantiation surface the reference builds on Hydra + OmegaConf (reference:
configs/**, src/main.py:214). ``instantiate`` retargets each ``msla_tpu.``
target to the port's ``msla_tpu_torch.`` counterpart.
"""
from msla_tpu_torch.config.compose import ComposeError, compose
from msla_tpu_torch.config.instantiate import InstantiationError, get_class, instantiate
from msla_tpu_torch.config.node import ConfigNode, InterpolationError
from msla_tpu_torch.config.runtime import setup_job_logging, setup_root, setup_run_dir

__all__ = [
    "ComposeError",
    "ConfigNode",
    "InstantiationError",
    "InterpolationError",
    "compose",
    "get_class",
    "instantiate",
    "setup_job_logging",
    "setup_root",
    "setup_run_dir",
]
