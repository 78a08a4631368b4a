"""Replication layer of the port: the change log and its wire framing.

``ChangeLog`` is the record-level insert/delete log (LSN-stamped columnar
arrays, npz-serializable) that ``repro_torch.core.index.OnlineIndex``
journals its mutations in and folds on ``rebuild``; ``wire`` holds the
CRC32C frame header and the typed errors (``FrameSchemaError`` is what a
foreign payload raises).  Both are numpy-only copies of the reference's
modules.  The replica, the stream, the transports, the chaos layer and
the supervisor come with ROADMAP Queue 1 item 10.
"""

from .log import OP_DELETE, OP_INSERT, ChangeLog  # noqa: F401
from .wire import (  # noqa: F401
    FrameCorrupt,
    FrameHeader,
    FrameSchemaError,
    WireError,
)

__all__ = [
    "ChangeLog",
    "OP_INSERT",
    "OP_DELETE",
    "WireError",
    "FrameCorrupt",
    "FrameSchemaError",
    "FrameHeader",
]
