"""Continuous-batching serving of the port: engine, slab and paged KV
pools, scheduler, sampling and the prefill/decode/paged steps."""
from repro_torch.serve.engine import ServeEngine                 # noqa: F401
from repro_torch.serve.kv_pool import KVPool, PagedKVPool        # noqa: F401
from repro_torch.serve.scheduler import FIFOScheduler, Request   # noqa: F401
from repro_torch.serve import steps                              # noqa: F401
