"""Task builders and token sources (numpy draws identical to
``repro.data``'s)."""
from . import edge_tasks, lm_data, paper_tasks
