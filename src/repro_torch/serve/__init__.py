"""Continuous-batching serving of the port: engine, slab KV pool,
scheduler, sampling and the prefill/decode steps."""
from repro_torch.serve.engine import ServeEngine                 # noqa: F401
from repro_torch.serve.kv_pool import KVPool                     # noqa: F401
from repro_torch.serve.scheduler import FIFOScheduler, Request   # noqa: F401
from repro_torch.serve import steps                              # noqa: F401
