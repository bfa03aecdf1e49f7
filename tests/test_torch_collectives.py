"""The port's qwZ gathers: world-1 semantics and a 2-rank gloo gather.

At world 1 (no process group, or a group of one) the gather is the shard
itself and the quantize/dequantize still run — the reference's semantics
on a one-device mesh.  With two gloo ranks on the CPU each rank quantizes
its own shard and the gathered result must equal the blockwise round trip
of the whole buffer (blocks never straddle shards), on every rank.
"""
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import collectives as cl
from repro_torch.core import quant as tq
from repro_torch.core.zeropp import ZeroConfig, fwd_gather, fwd_gather_quant

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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank, world, port):
    """One gloo rank; exits 0 iff its gathered buffer is the round trip of
    the whole buffer, bit for bit."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        full = _full()
        per = N // world
        shard = full[rank * per:(rank + 1) * per]
        cfg = tq.QuantConfig()
        assert cl.world_size() == world
        got = cl.qwz_all_gather(shard, None, cfg, out_dtype=torch.float32)
        ok = torch.equal(got, _roundtrip(full, cfg, torch.float32))
    finally:
        dist.destroy_process_group()
    sys.exit(0 if ok else 1)


def test_two_rank_gloo_qwz_gather_matches_whole_buffer_round_trip():
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, 2, port)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert alive == [False, False]
    assert [p.exitcode for p in procs] == [0, 0]
