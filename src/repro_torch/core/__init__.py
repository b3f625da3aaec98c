"""CHB core in PyTorch: tree utilities, accounting, eq. (8), int8, simulator."""
from . import accounting, censoring, quantize, simulator, util
