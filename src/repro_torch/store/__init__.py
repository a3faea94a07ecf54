"""LatentBox object-store API on the port: the facade, its engine
backend, and the shared tier walk.  Only the facade and the API value
types are imported here; the segment log, sharding and replication are
not part of this package yet."""

from repro_torch.store.api import (GetResult, HIT_CLASSES, ObjectStat,
                                   PutResult, StoreConfig)
from repro_torch.store.facade import LatentBox

__all__ = ["LatentBox", "StoreConfig", "GetResult", "PutResult",
           "ObjectStat", "HIT_CLASSES"]
