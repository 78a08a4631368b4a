"""Replication layer of the port: change logs, replicas, and the async stream.

``ChangeLog`` is the record-level insert/delete log (LSN-stamped columnar
arrays, npz-serializable — the checkpoint layer stores one next to a base
step for delta checkpoints, and ``repro_torch.core.index.OnlineIndex``
journals its mutations in one); ``Replica`` consumes log batches and keeps
its index current through ``ReconstructionPipeline.run_incremental`` on
its backend (``"cuda"``: the hand-written kernels, the insert rule's rank
search included).

The async stream (``repro_torch.replication.stream``) ships log batches
from a ``StreamPrimary`` to N ``StreamReplica`` consumers over a pluggable
``transport`` (in-memory queue or spool directory), with LSN-watermark
idempotency, bounded-lag backpressure, and checkpoint-chain catch-up
(``repro_torch.ckpt``: the replica rebuilds its index from the
checkpointed table and DS-metadata, the paper's index recovery).

The fault layer hardens the stream against an adversarial wire: every
frame carries a CRC32C integrity header (``repro_torch.replication.wire``),
``FaultyTransport`` injects seeded delivery faults for testing
(``repro_torch.replication.chaos``), and ``ReplicaSupervisor`` walks the
retry/backoff/resync/quarantine degradation ladder around ``poll``
(``repro_torch.replication.supervisor``).  The frames, checkpoints and
fault schedules are the reference package's, so either package reads
what the other wrote.  See docs/replication.md for the protocol and the
fault model.
"""

from .chaos import ChaosPlan, FaultyTransport  # noqa: F401
from .log import OP_DELETE, OP_INSERT, ChangeLog  # noqa: F401
from .replica import Replica  # noqa: F401
from .stream import (  # noqa: F401
    BackpressureError,
    BatchFrame,
    CheckpointFrame,
    LsnGapError,
    ShedFrame,
    StreamError,
    StreamPrimary,
    StreamReplica,
    decode_frame,
    encode_frame,
    peek_header,
)
from .supervisor import ReplicaSupervisor, SupervisorPolicy  # noqa: F401
from .transport import (  # noqa: F401
    DirectoryTransport,
    FrameTruncated,
    QueueTransport,
    Transport,
)
from .wire import (  # noqa: F401
    FrameCorrupt,
    FrameHeader,
    FrameSchemaError,
    WireError,
)

__all__ = [
    "ChangeLog",
    "Replica",
    "OP_INSERT",
    "OP_DELETE",
    "Transport",
    "QueueTransport",
    "DirectoryTransport",
    "FrameTruncated",
    "StreamPrimary",
    "StreamReplica",
    "BatchFrame",
    "CheckpointFrame",
    "ShedFrame",
    "encode_frame",
    "decode_frame",
    "peek_header",
    "StreamError",
    "LsnGapError",
    "BackpressureError",
    "WireError",
    "FrameCorrupt",
    "FrameSchemaError",
    "FrameHeader",
    "ChaosPlan",
    "FaultyTransport",
    "ReplicaSupervisor",
    "SupervisorPolicy",
]
