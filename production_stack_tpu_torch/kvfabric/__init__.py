"""Peer-to-peer KV fabric, the port's copy of production_stack_tpu/kvfabric/:
one engine-to-engine transfer plane of versioned, CRC-framed (pages, scales)
frames. The port's engines use it for disaggregated prefill's streamed push
(the only path for int8 pools), the fleet directory's resident-page pulls
and live migration's page-chain ships, each with the tiers as its fallback."""

from production_stack_tpu_torch.kvfabric.client import KVFabricClient
from production_stack_tpu_torch.kvfabric.peers import (
    PeerLink,
    PeerProbeCache,
    pick_best_peer,
    transfer_cost_score,
)
from production_stack_tpu_torch.kvfabric.server import KVFabricServer
from production_stack_tpu_torch.kvfabric.wire import (
    FABRIC_WIRE_VERSION,
    FabricWireError,
    FrameAssembler,
    decode_frame,
    encode_frame,
    frame_to_blobs,
    verify_frame,
)

__all__ = [
    "FABRIC_WIRE_VERSION",
    "FabricWireError",
    "FrameAssembler",
    "KVFabricClient",
    "KVFabricServer",
    "PeerLink",
    "PeerProbeCache",
    "decode_frame",
    "encode_frame",
    "frame_to_blobs",
    "pick_best_peer",
    "transfer_cost_score",
    "verify_frame",
]
