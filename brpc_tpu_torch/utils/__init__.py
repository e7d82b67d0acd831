"""Helpers of the port: device resolution, parameter carry-over and
training checkpoints."""

from .checkpoint import TensorSpec, TrainCheckpointer, abstract_like

__all__ = ["TensorSpec", "TrainCheckpointer", "abstract_like"]
