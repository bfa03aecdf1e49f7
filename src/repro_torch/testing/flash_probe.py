"""B7's dk/dv precision and time at large GQA groups, on the card.

    python3 src/repro_torch/testing/flash_probe.py [--root TREE] [--oracle]

Imports the port from ``TREE/src`` (default: this checkout), builds the
bf16 flash library and, at each shape of ``SHAPES`` (causal, bf16 inputs
drawn from a seeded generator), prints B7's median time (CUDA events, L2
flushed before each launch) and dq/dk/dv's worst reading in units of the
per-element bar of ``testing/flash_bars.py`` against the plain version,
and whether two launches give the same bits.  With ``--oracle`` it also
prints, for dk and dv, the worst relative distance (|x| + 1e-3 in the
denominator) of the kernel and of the plain version from a float64
oracle, and the bar reading of an exact-fp32 emulation of the kernel's
arithmetic (p and dl split into bf16 hi + lo parts, products summed in
fp32): a kernel that misses where the emulation holds loses precision in
its accumulation, not in the split.

To compare two trees, unpack the parent into a directory the repository's
``.gitignore`` lists and run parent, change, change, parent in one call:

    git archive <parent> src | tar -x -C results/parent
    for r in results/parent . . results/parent; do
        python3 src/repro_torch/testing/flash_probe.py --root $r; done
"""
from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

# (B, S, H, K, hd, causal window): qwen3-0.6b's training shape, qwen2-vl-
# 72b's (GQA 8), gemma3-4b's local layers (hd 256), and GQA 12 / 16 groups
SHAPES = ((8, 2048, 16, 8, 128, 0), (4, 2048, 64, 8, 128, 0),
          (2, 4096, 8, 4, 256, 1024), (1, 1024, 24, 2, 128, 0),
          (1, 1024, 32, 2, 128, 0), (1, 1024, 24, 2, 64, 0))


def _split(x, terms: int):
    """``x`` as the sum of ``terms`` bf16 parts (exact in fp32)."""
    import torch
    out = torch.zeros_like(x)
    for _ in range(terms):
        out = out + (x - out).to(torch.bfloat16).float()
    return out


def _dense(q, k, v, out, do, scale: float, window: int, dtype):
    """(p, dl, q, dO) of causal attention in ``dtype`` with the K/V heads
    repeated over their groups: p the exact softmax, dl = p·(dP − D)."""
    import torch
    B, S, H, hd = q.shape
    r = H // k.shape[2]
    qd, kd, vd, od, dod = (t.to(dtype) for t in (q, k, v, out, do))
    kr, vr = kd.repeat_interleave(r, 2), vd.repeat_interleave(r, 2)
    lg = torch.einsum("bqhd,bshd->bhqs", qd, kr) * scale
    pos = torch.arange(S, device=q.device)
    keep = pos[:, None] >= pos[None, :]
    if window:
        keep &= pos[:, None] - pos[None, :] < window
    p = torch.softmax(lg.masked_fill(~keep, float("-inf")), -1)
    dp = torch.einsum("bqhd,bshd->bhqs", dod, vr)
    dl = p * (dp - (dod * od).sum(-1).permute(0, 2, 1)[..., None])
    return p, dl, qd, dod


def _dkdv(p, dl, qd, dod, scale: float, K: int):
    """dk, dv (B, S, K, hd) summed over each group's heads."""
    import torch
    B, S, H, hd = qd.shape
    dk = torch.einsum("bhqs,bqhd->bshd", dl, qd) * scale
    dv = torch.einsum("bhqs,bqhd->bshd", p, dod)
    return tuple(t.reshape(B, S, K, H // K, hd).sum(3) for t in (dk, dv))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[3]))
    ap.add_argument("--oracle", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import platform, ref
    from repro_torch.testing import flash_bars
    if not torch.cuda.is_available():
        raise SystemExit("flash_probe needs a CUDA device")
    platform.build(["flash_attention_tc"])
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def median_ms(fn, n: int = 15) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(n):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    print(f"root {args.root}", flush=True)
    for i, (B, S, H, K, hd, window) in enumerate(SHAPES):
        g = torch.Generator(device="cuda")
        g.manual_seed(i)
        q, k, v, do = (torch.randn(B, S, n, hd, generator=g, device="cuda")
                       .to(torch.bfloat16) for n in (H, K, K, H))
        kw = dict(scale=hd ** -0.5, causal=True, window=window)
        out, m, l = fa.flash_fwd(q, k, v, **kw)
        got = fa.flash_bwd(q, k, v, out, m, l, do, **kw)
        want = ref.flash_bwd_ref(q, k, v, out, m, l, do, **kw)
        bars = [flash_bars.worst(a, b, flash_bars.grad_bar(b))[0]
                for a, b in zip(got, want)]
        again = fa.flash_bwd(q, k, v, out, m, l, do, **kw)
        same = all(torch.equal(a, b) for a, b in zip(again, got))
        ms = median_ms(lambda: fa.flash_bwd(q, k, v, out, m, l, do, **kw))
        line = (f"  (B {B}, S {S}, H {H}, K {K}, hd {hd}, window {window}): "
                f"B7 {ms:.4f} ms; dq/dk/dv {bars[0]:.3f} / {bars[1]:.3f} / "
                f"{bars[2]:.3f} x the bar; two launches the same bits: "
                f"{same}")
        if args.oracle and B * H * S * S <= 1 << 26:
            scale = kw["scale"]
            exact = _dkdv(*_dense(q, k, v, out, do, scale, window,
                                  torch.float64), scale, K)
            p, dl, qf, dof = _dense(q, k, v, out, do, scale, window,
                                    torch.float32)
            emu = _dkdv(_split(p, 2), _split(dl, 2), qf, dof, scale, K)
            for name, a, b, e, x in zip(("dk", "dv"), got[1:], want[1:],
                                        emu, exact):
                rel = [((t.double() - x).abs() / (x.abs() + 1e-3)).max()
                       .item() for t in (a, b)]
                r_emu = flash_bars.worst(e.to(torch.bfloat16), b,
                                         flash_bars.grad_bar(b))[0]
                line += (f"; {name} from float64: kernel {rel[0]:.2e}, "
                         f"plain {rel[1]:.2e}, hi + lo emulation "
                         f"{r_emu:.3f} x the bar")
        print(line, flush=True)
        del q, k, v, do, out, m, l, got, want, again


if __name__ == "__main__":
    main()
