"""Disaggregated prefill/decode serving: the JAX package's ``llm/disagg``.

Long prefills are offloaded from decode workers to dedicated prefill
workers through a work queue on the hub; the prefill worker computes the
prompt's KV and pushes the blocks into the decode worker's pages over the
service plane (msgpack binary frames, engine/transfer.py's checksummed
payload; the device-to-device path when both engines share a process).
The blocks land as sealed, hash-addressed blocks, so the decode pass sees
them as a prefix-cache hit and the scheduler needs no remote mode.
"""

from .prefill_queue import PrefillQueue, prefill_queue_name  # noqa: F401
from .router import DisaggConfig, DisaggregatedRouter, disagg_config_key, publish_config  # noqa: F401
from .worker import KV_IMPORT_ENDPOINT, DisaggDecodeWorker, PrefillWorkerLoop  # noqa: F401
