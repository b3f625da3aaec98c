"""Model configurations (port of ``repro/configs``; the files are data)."""
from .base import ModelConfig
from .registry import ARCHS, ASSIGNED, get
