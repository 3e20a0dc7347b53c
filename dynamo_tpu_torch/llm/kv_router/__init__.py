"""KV event and worker-metrics protocol types."""
