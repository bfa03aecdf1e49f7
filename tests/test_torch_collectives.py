"""The port's qwZ gathers: world-1 semantics and a 2-rank gloo gather.

At world 1 (no process group, or a group of one) the gather is the shard
itself and the quantize/dequantize still run — the reference's semantics
on a one-device mesh.  With two gloo ranks on the CPU each rank quantizes
its own shard and the gathered result must equal the blockwise round trip
of the whole buffer (blocks never straddle shards), on every rank.
"""
import torch

from repro_torch.core import collectives as cl
from repro_torch.core import quant as tq
from repro_torch.core.zeropp import ZeroConfig, fwd_gather, fwd_gather_quant
from repro_torch.testing import multirank

N = 4096


def _full():
    g = torch.Generator().manual_seed(3)
    return (torch.randn(N, generator=g) * 2).to(torch.bfloat16)


def _roundtrip(x, cfg, out_dtype):
    p, s = tq.quantize_blockwise(x, cfg)
    return tq.dequantize_blockwise(p, s, cfg, out_dtype)


def test_world_one_gathers_the_shard_through_the_round_trip():
    x = _full()
    z = ZeroConfig(dp_axes=("model",))
    assert cl.world_size() == 1
    assert torch.equal(fwd_gather(x, z), _roundtrip(x, z.qwz_cfg,
                                                    torch.bfloat16))
    p, s = fwd_gather_quant(x, z)
    assert p.dtype == torch.int8 and tuple(s.shape) == (N // 256,)
    # baseline (qwz off): the shard itself in compute dtype; local mode
    # (no ZeRO world): a plain cast, no quantization
    zb = ZeroConfig(qwz=False, dp_axes=("model",),
                    compute_dtype=torch.float32)
    assert torch.equal(fwd_gather(x, zb), x.float())
    zl = ZeroConfig(dp_axes=(), compute_dtype=torch.float32)
    assert torch.equal(fwd_gather(x, zl), x.float())


def _rank(rank, world):
    """True iff this rank's gathered buffer is the round trip of the whole
    buffer, bit for bit."""
    full = _full()
    per = N // world
    shard = full[rank * per:(rank + 1) * per]
    cfg = tq.QuantConfig()
    assert cl.world_size() == world
    got = cl.qwz_all_gather(shard, None, cfg, out_dtype=torch.float32)
    return bool(torch.equal(got, _roundtrip(full, cfg, torch.float32)))


def test_two_rank_gloo_qwz_gather_matches_whole_buffer_round_trip():
    assert multirank.run(_rank, 2) == [True, True]
