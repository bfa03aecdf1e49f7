"""Quickstart: ZeRO++ training on the PyTorch/CUDA port in ~60 lines.

gpt-350m reduced on a 4 x 2 world ("data" = the slow tier, "model" = the
fast intra-node tier): one gloo rank process a position, all on the card
(device 0) by default, or on the CPU with ``--device cpu``.  Each rank
holds its flat shard of every parameter; the step gathers the weights
with qwZ (INT8 blocks), re-gathers them for the backward from hpZ's
secondary shard and reduces the gradients with qgZ (INT4, two hops).

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.configs import get_config             # noqa: E402
from repro_torch.data.synthetic import SyntheticLM     # noqa: E402
from repro_torch.kernels import platform               # noqa: E402
from repro_torch.launch import mesh as mesh_lib        # noqa: E402
from repro_torch.launch.train import device_batch      # noqa: E402
from repro_torch.models.model import Model             # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.train.policy import make_policy       # noqa: E402
from repro_torch.train.state import init_shards        # noqa: E402
from repro_torch.train.trainer import build_train_step  # noqa: E402


def rank_main(rank, world, shape, device, steps, batch, seq):
    # 1. this rank's view of the world: the mesh's axes and groups
    mesh = mesh_lib.make_mesh(shape)

    # 2. architecture + ZeRO++ policy (qwZ INT8 + hpZ + qgZ INT4 by default)
    arch = get_config("gpt-350m").reduced()
    pol = make_policy(arch, mesh.axes, mesh=mesh)      # variant="zeropp"
    model = Model(arch, pol.zcfg, world=world, device=device)
    if rank == 0:
        print(f"model: {model.n_params() / 1e6:.1f}M params on "
              f"{'x'.join(map(str, shape))} ranks ({device}) | "
              f"qwZ={pol.zcfg.qwz} hpZ={pol.zcfg.hpz} qgZ={pol.zcfg.qgz}",
              flush=True)

    # 3. this rank's train step, its shards of the seeded params and AdamW
    opt_cfg = AdamWConfig(lr=3e-3, moments_dtype=pol.moments_dtype)
    step = build_train_step(model, opt_cfg, device=device,
                            global_batch=batch, mesh=mesh)
    params = init_shards(model, seed=0)
    opt = init_opt_state(params, opt_cfg)

    # 4. deterministic synthetic LM data (the GLOBAL batch: each rank cuts
    #    its rows), a few steps
    lm = SyntheticLM(vocab=arch.vocab, seq_len=seq, seed=0)
    losses = []
    for i in range(steps):
        data = device_batch(arch, lm, i, batch, 1, model.device)
        metrics = step.fn(params, opt, data)
        losses.append(float(metrics["loss"]))
        if rank == 0:
            print(f"step {i}: loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
    if rank == 0:
        print(f"(best achievable loss = data entropy bound "
              f"{lm.entropy_bound:.3f})", flush=True)
        # the hand-written kernels this rank launched (0 on the CPU, which
        # runs their plain versions)
        print(f"kernel launches on rank 0: "
              f"{json.dumps(dict(platform.LAUNCHES))}", flush=True)
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mesh", default="4x2")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args(argv)
    shape = mesh_lib.parse_mesh(args.mesh)
    world = mesh_lib.Mesh(shape).world
    run = (args.device, args.steps, args.batch, args.seq)
    if world == 1:
        return rank_main(0, 1, shape, *run)
    return mesh_lib.spawn(rank_main, world, shape, *run,
                          device=args.device, timeout=None)[0]


if __name__ == "__main__":
    main()
