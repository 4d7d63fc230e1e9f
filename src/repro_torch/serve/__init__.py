"""The port's graph-query serving tier (the counterpart of
:mod:`repro.serve`): admission control + deadline-aware continuous
batching (:class:`GraphServer`) over ``run_batch``, multi-tenant resident
graphs with swap epochs, a pinned distance/landmark cache and the record
of dispatched K-buckets, all instrumented through one metric dict.
"""

from repro_torch.serve.cache import (  # noqa: F401
    DistanceCache, ExecutableCache, ExecutableEntry, LRUCache)
from repro_torch.serve.clock import SimulatedClock, SystemClock  # noqa: F401
from repro_torch.serve.metrics import Metrics, percentile  # noqa: F401
from repro_torch.serve.server import (  # noqa: F401
    GraphServer, Request, Response, k_bucket,
    REJECT_DEADLINE, REJECT_QUEUE_FULL, REJECT_UNKNOWN_GRAPH)
