"""Live sequence migration: preemption-free KV + decode-state handoff.

Reference motivation: Llumnix (OSDI'24) — live cross-instance migration is
the primitive that turns rescheduling decisions (scale-down, role flips,
defragmentation, crash recovery) into cheap actions.  The KV plane reuses
engine/transfer.py's hash-addressed export/inject; the decode state rides a
``SequenceSnapshot``; the stream splice is the routed client's job
(runtime/client.py consumes the ``migrated`` marker and re-dispatches).

A port of the JAX package's ``llm/migration`` (its docs/migration.md has
the protocol and failure matrix).  The copy stream rides the service
plane, or the bulk data plane under ``DYN_BULK_PLANE`` (worker.py).
"""

from .coordinator import (
    drain_via_migration,
    pick_migration_target,
    request_migrate_out,
    target_from_instance,
)
from .snapshot import SequenceSnapshot
from .worker import (
    MIGRATE_IN_ENDPOINT,
    MIGRATE_OUT_ENDPOINT,
    MigratableWorker,
    MigrationTargetError,
)

__all__ = [
    "SequenceSnapshot",
    "MigratableWorker",
    "MigrationTargetError",
    "MIGRATE_IN_ENDPOINT",
    "MIGRATE_OUT_ENDPOINT",
    "pick_migration_target",
    "target_from_instance",
    "drain_via_migration",
    "request_migrate_out",
]
