"""Live sequence migration, the port's copy of the engine side of
production_stack_tpu/migration/: a *running* sequence's KV page chain
(shipped over the KV fabric, or through the offload tiers, CRC-verified
exactly like warm-start blobs), its sampling and decode state (token history
= position + emitted count, params) and its presentation metadata are
snapshotted into a sealed wire document, shipped to another engine, and
resumed mid-stream with bit-identical greedy continuation. The router splices
the continued SSE stream so the client sees one uninterrupted response.

The fleet controller that decides rebalance, drain and warm-up stays the JAX
package's (``scripts/fleet_controller.py``, a separate process that imports
no jax): it drives port engines through their ``/migratable`` and
``/migrate_*`` routes.
"""

from production_stack_tpu_torch.migration.manager import (  # noqa: F401
    MigrationError,
    MigrationManager,
)
from production_stack_tpu_torch.migration.state import (  # noqa: F401
    SNAPSHOT_FORMAT,
    SequenceSnapshot,
    continuation_params,
    snapshot_from_wire,
    snapshot_to_wire,
    unmigratable_reason,
)
