"""KV event and worker-metrics protocol types.  The package exports the
event recorder (recorder.py), as the JAX package's ``llm/kv_router``
does; the other modules are imported by path."""

from .recorder import KvRecorder, replay_events  # noqa: F401
