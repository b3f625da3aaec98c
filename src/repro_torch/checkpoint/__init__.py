"""Checkpoints of parameter trees (port of ``repro/checkpoint``)."""
from . import checkpoint
