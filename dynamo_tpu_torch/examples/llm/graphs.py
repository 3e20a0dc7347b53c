"""Deployable graphs (reference: examples/llm/graphs/*.py), the port's copy
of the JAX package's ``examples/llm/graphs.py``.

- ``agg``        — Frontend → Processor → TorchWorker, single linked graph.
- ``agg_router`` — same topology; deploy with the runner's ``--router kv``
  so the HTTP edge routes KV-aware.
"""

from ...sdk import Graph
from .components import Frontend, Processor, TorchWorker  # noqa: F401

agg = Graph(Frontend)
agg_router = Graph(Frontend)  # pair with: runner --router kv
