"""LatentBox object-store API on the port: the facade and the API value
types.  The backends, the segment log (``store.durable``), sharding,
replication and fault plans are imported from their own modules
(``repro_torch.store.backends``, ``.sharding``, ``.replication``,
``.faults``); nothing of them is imported eagerly here."""

from repro_torch.store.api import (GetResult, HIT_CLASSES, ObjectStat,
                                   PutResult, StoreConfig)
from repro_torch.store.facade import LatentBox

__all__ = ["LatentBox", "StoreConfig", "GetResult", "PutResult",
           "ObjectStat", "HIT_CLASSES"]
