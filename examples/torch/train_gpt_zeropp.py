"""End-to-end run: train a ~100M-param GPT with full ZeRO++ on the
PyTorch/CUDA port for a few hundred steps, with periodic checkpoints.

Uses the production launcher (``repro_torch.launch.train``), the same code
path a real run uses, on a 4 x 2 world of gloo ranks (all on the card, or
on the CPU with ``--device cpu``):

  PYTHONPATH=src python examples/torch/train_gpt_zeropp.py [--steps 200]

``--tiny`` is a seconds-scale smoke version (the reduced config).
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import repro_torch.configs as configs                  # noqa: E402
from repro_torch.configs.base import ArchConfig        # noqa: E402
from repro_torch.launch import train as train_mod      # noqa: E402

# ~95M params: a real (if small) transformer, not a toy
GPT_100M = ArchConfig(
    name="gpt-100m", n_layers=12, d_model=768, vocab=8192,
    pattern=("attn",), n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "zeropp_gpt100m"))
    ap.add_argument("--ckpt-format", default="fp32", choices=["fp32", "int8"],
                    help="per-shard checkpoint payload (int8 = qwZ-style "
                         "block-quantized, ~4x smaller)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def launcher_argv(args) -> list:
    """The launcher's command line for this example's run."""
    argv = ["--arch", GPT_100M.name, "--mesh", "4x2",
            "--steps", str(args.steps), "--batch", "8", "--seq", "128",
            "--lr", "1e-3", "--ckpt-dir", args.ckpt_dir,
            "--ckpt-format", args.ckpt_format,
            "--ckpt-every", "50", "--log-every", "10",
            "--device", args.device]
    if args.tiny:
        argv += ["--reduced", "--steps", "20", "--batch", "16",
                 "--seq", "64", "--lr", "3e-3"]
    return argv


def main(argv=None):
    train_mod.main(launcher_argv(parser().parse_args(argv)))


# register the config so --arch finds it, here and in every spawned rank
# (which runs this script as its main module, "__mp_main__")
if __name__ in ("__main__", "__mp_main__"):
    configs._R.setdefault(GPT_100M.name, GPT_100M)

if __name__ == "__main__":
    main()
