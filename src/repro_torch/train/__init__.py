"""The CHB training loop at LM scale (port of ``repro/train``)."""
from . import trainer
