"""Boot-time tuning of the ZeRO++ policy (the reference's ``tune/``).

One owner for every ZeRO++ knob: probe the live world
(:mod:`repro_torch.tune.probe`), charge HBM honestly, the (k+1) ring
buffers included (:mod:`repro_torch.tune.memory`), and resolve the
configuration through one deterministic decision list
(:mod:`repro_torch.tune.resolve`).
"""
from repro_torch.tune.memory import (GB, HBM_BYTES, HBMLedger, LedgerLine,
                                     ring_lines, serve_ledger, train_ledger)
from repro_torch.tune.probe import (STATIC_PROFILE_PATH, ProbeProfile,
                                    TierProfile, probe_mesh, static_profile)
from repro_torch.tune.resolve import (LARGE_PARAMS, MODES, ResolvedPolicy,
                                      count_params, resolve)

__all__ = [
    "GB", "HBM_BYTES", "HBMLedger", "LedgerLine", "ring_lines",
    "serve_ledger", "train_ledger",
    "STATIC_PROFILE_PATH", "ProbeProfile", "TierProfile", "probe_mesh",
    "static_profile",
    "LARGE_PARAMS", "MODES", "ResolvedPolicy", "count_params", "resolve",
]
