"""Serving example: the continuous-batching engine of the PyTorch/CUDA port
(``repro_torch.serve``), qwen3-0.6b at full width.

Requests with DIFFERENT prompt lengths run through one engine: they are
admitted into KV-pool slots, prefilled individually (prompt-length buckets
bound the prefill shapes), and decoded TOGETHER by one batched decode step
with a per-sequence ``cache_pos`` vector.  Tokens stream per request as
they are sampled.  Parameters stay ZeRO-sharded (flat buffers over the
whole world, one gloo rank a position of ``--mesh``, every rank running
the engine's host loop in lockstep) and every layer group is gathered per
step with qwZ INT8, the serving analogue of the paper's forward path; the
head's GEMM runs on the INT8 weights (the dequant-matmul kernel).

With ``--from-ckpt`` the parameters are written through the per-shard
checkpoint format (``--ckpt-format``, INT8 by default) and the engine boots
from it through the bf16 serving load (``ServeEngine.from_checkpoint``):
the deployment flow for a trained model.

  PYTHONPATH=src python examples/torch/serve_decode.py --temperature 0.8 \\
      --top-k 40 --top-p 0.95 --max-new-tokens 12 [--mesh 1x1] \\
      [--device cpu --reduced]
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np                                      # noqa: E402
import torch                                            # noqa: E402

from repro_torch.configs import get_config              # noqa: E402
from repro_torch.kernels import platform                # noqa: E402
from repro_torch.launch import mesh as mesh_lib         # noqa: E402
from repro_torch.models.model import Model              # noqa: E402
from repro_torch.serve import ServeEngine               # noqa: E402
from repro_torch.train.policy import make_policy        # noqa: E402
from repro_torch.train.state import ZeroState, init_shards  # noqa: E402


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's tiny test shape (CPU runs)")
    ap.add_argument("--prompt-lens", default="5,12,9",
                    help="comma-separated prompt lengths (mixed in one run)")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-len", type=int, default=64,
                    help="KV pool capacity per slot")
    ap.add_argument("--slots", type=int, default=2,
                    help="decode batch size (fewer slots than requests "
                         "exercises slot recycling)")
    ap.add_argument("--from-ckpt", action="store_true",
                    help="roundtrip params through a per-shard checkpoint "
                         "and boot the engine from it")
    ap.add_argument("--ckpt-format", default="int8", choices=("int8", "fp32"))
    ap.add_argument("--prefetch", type=int, default=None,
                    help="weight-gather ring depth for the serving path "
                         "(clamps to n_layers-1; default: the policy's)")
    ap.add_argument("--mesh", default="2x2",
                    help="YxX or PxYxX world, one gloo rank a position")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def rank_main(rank, world, args, ckpt_dir):
    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = mesh_lib.make_mesh(mesh_lib.parse_mesh(args.mesh))
    arch = get_config(args.arch)
    if args.reduced:
        arch = arch.reduced()
    over = {} if args.prefetch is None else {"prefetch": args.prefetch}
    pol = make_policy(arch, mesh.axes, mesh=mesh, **over)
    model = Model(arch, pol.zcfg, world=world, device=args.device)

    # this rank's shards of the seeded params; serving computes in bf16
    params = init_shards(model, seed=0)
    kw = dict(n_slots=args.slots, kv_len=args.kv_len, device=args.device,
              kv_axes=("model",) if world > 1 else ())
    if world > 1:
        kw["mesh"] = mesh
    if args.from_ckpt:
        path = ZeroState(model, mesh, params=params,
                         meta={"arch": arch.name}).save(
            ckpt_dir, step=0, fmt=args.ckpt_format)
        del params
        engine = ServeEngine.from_checkpoint(model, ckpt_dir, **kw)
        say(f"[serve] engine <- {path} ({args.ckpt_format} per-shard "
            f"checkpoint, bf16 load)", flush=True)
    else:
        engine = ServeEngine(model, {k: v.to(torch.bfloat16)
                                     for k, v in params.items()}, **kw)

    lens = [int(x) for x in args.prompt_lens.split(",")]
    rng = np.random.default_rng(args.seed)
    streams = {}

    def on_token(uid, tok):
        streams[uid].append(tok)
        say(f"  [stream] req {uid}: +{tok}  ({len(streams[uid])} tokens)",
            flush=True)

    uids = []
    for i, P in enumerate(lens):
        prompt = rng.integers(0, arch.vocab, P).astype(np.int32)
        uid = engine.submit(prompt, max_new_tokens=args.max_new_tokens,
                            temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, seed=args.seed + i,
                            on_token=on_token)
        streams[uid] = []
        uids.append((uid, prompt))
        say(f"req {uid}: prompt_len={P} "
            f"bucket={engine.scheduler.bucket_for(P)}", flush=True)

    results = engine.run(max_steps=1000)
    say(f"\n{args.slots} slots served {len(lens)} requests on "
        f"{args.mesh} ({args.device}; slot map: {engine.slot_history})")
    for uid, prompt in uids:
        say(f"req {uid}: prompt={prompt.tolist()} "
            f"generated={results[uid]}")
    st = engine.stats()

    def _ms(d):
        return (f"p50 {d['p50']:.1f}ms / p99 {d['p99']:.1f}ms"
                if d.get("p50") is not None else "n/a")

    tps = st["tok_per_s"]
    say(f"\n[serve] stats: admitted={st['admitted']} "
        f"completed={st['completed']} expired={st['expired']} "
        f"steps={st['steps']} occupancy={st['occupancy']:.2f}")
    say(f"[serve] TTFT {_ms(st['ttft_ms'])}  "
        f"per-token {_ms(st['tok_latency_ms'])}  "
        f"throughput {'n/a' if tps is None else f'{tps:.1f} tok/s'}",
        flush=True)
    # the hand-written kernels this rank launched (0 on the CPU)
    say(f"kernel launches on rank 0: {json.dumps(dict(platform.LAUNCHES))}",
        flush=True)
    return [results[uid] for uid, _ in uids]


def main(argv=None):
    args = parser().parse_args(argv)
    world = mesh_lib.Mesh(mesh_lib.parse_mesh(args.mesh)).world
    ckpt_dir = tempfile.mkdtemp(prefix="zeropp_serve_ckpt_")
    try:
        if world == 1:
            return rank_main(0, 1, args, ckpt_dir)
        return mesh_lib.spawn(rank_main, world, args, ckpt_dir,
                              device=args.device, timeout=None)[0]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
