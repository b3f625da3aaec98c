"""Task builders (numpy draws identical to ``repro.data``'s)."""
from . import edge_tasks, paper_tasks
