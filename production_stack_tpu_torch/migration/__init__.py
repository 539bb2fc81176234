"""Live sequence migration, the port's copy of the engine side of
production_stack_tpu/migration/: a *running* sequence's KV page chain
(shipped over the KV fabric, or through the offload tiers, CRC-verified
exactly like warm-start blobs), its sampling and decode state (token history
= position + emitted count, params) and its presentation metadata are
snapshotted into a sealed wire document, shipped to another engine, and
resumed mid-stream with bit-identical greedy continuation. The router splices
the continued SSE stream so the client sees one uninterrupted response.

``controller`` is the port's copy of the saturation-driven fleet controller
that decides rebalance, drain and warm-up (``scripts/fleet_controller_torch.py``
is its CLI): it drives engines through their ``/migratable`` and
``/migrate_*`` routes, and imports neither the JAX package nor torch.
"""

from production_stack_tpu_torch.migration.controller import (  # noqa: F401
    Action,
    BackendView,
    ControllerPolicy,
    FleetController,
    FleetDecider,
)

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
