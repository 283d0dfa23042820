"""Parallelism rules of the port (``repro/parallel``): so far only the CNN
rule rows the 2D mesh splitter reads (:mod:`repro_torch.parallel.sharding`)."""

from repro_torch.parallel.sharding import CNN_RULES, TP, cnn_param_spec

__all__ = ["CNN_RULES", "TP", "cnn_param_spec"]
