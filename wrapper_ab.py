#!/usr/bin/env python3
"""The port's kernel wrappers of this tree against another tree's, on one
NVIDIA card: what a call costs the host, where the host is the slower side.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 wrapper_ab.py --parent build/parent

Each side runs in its own process (both packages are named ``repro_torch``),
in turns (parent, this, this, parent, ...), and times calls back to back
through the public wrappers, between CUDA events (median of 5 runs of 20
calls): ``flash_attention_cuda`` at a host-bound shape (B 2, S 1,000, H 32,
KV 8, dh 80, window 100, the edge input of ``chip_smoke.py``) and at
h2o-danube-1.8b's serving shape (device-bound, the control), and
``ssd_scan_cuda`` and ``ssd_scan_bwd_cuda`` at B 2, S 1,000, H 32, P 64,
N 128.  Prints each turn, then each side's median per call beside the card's
name and power limit.  Both trees build their kernels into their own
``build/kernels/`` first, in parallel.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUILT = ("flash_attention", "ssd_scan", "ssd_scan_bwd")


def measure(tree: Path) -> dict:
    """Milliseconds a call through ``tree``'s wrappers, by case."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def per_call(fn, calls=20, runs=5):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(runs):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / calls)
        return statistics.median(out)

    q, k, v = rand(2, 1000, 32, 80), rand(2, 1000, 8, 80), rand(2, 1000, 8, 80)
    qs, ks, vs = (rand(8, 2048, 32, 80), rand(8, 2048, 8, 80),
                  rand(8, 2048, 8, 80))
    B, S, H, P, N = 2, 1000, 32, 64, 128
    xbc = rand(B, S, H * P + 2 * N)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = rand(B, S, H, dtype=torch.float32, scale=0.05).abs()
    a = -torch.rand((H,), generator=gen, device=dev) - 0.5
    dy = rand(B, S, H, P)
    states = ss.ssd_scan_cuda(x, dt, a, b, c, states=True)[2]
    return {
        "attention edge": per_call(lambda: fa.flash_attention_cuda(
            q, k, v, causal=True, window=100)),
        "attention serve": per_call(lambda: fa.flash_attention_cuda(
            qs, ks, vs, causal=True, window=4096)),
        "ssd forward": per_call(lambda: ss.ssd_scan_cuda(x, dt, a, b, c)),
        "ssd backward": per_call(lambda: ss.ssd_scan_bwd_cuda(
            x, dt, a, b, c, states, dy))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of the other tree (an unpacked git archive)")
    ap.add_argument("--turns", type=int, default=4,
                    help="turns of each side (default 4)")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure is not None:
        print(json.dumps(measure(args.measure)), flush=True)
        return 0
    trees = {"parent": args.parent.resolve(), "this": ROOT}
    code = ("import sys; sys.path.insert(0, 'src'); from repro_torch.kernels "
            f"import build; build.build({BUILT!r})")
    builds = [subprocess.Popen([sys.executable, "-c", code], cwd=tree)
              for tree in trees.values()]
    if any(p.wait() for p in builds):
        print("wrapper_ab: a build failed", file=sys.stderr)
        return 1
    order = ["parent", "this", "this", "parent"] * ((args.turns + 1) // 2)
    times = {side: [] for side in trees}
    for side in order[:2 * args.turns]:
        out = subprocess.run([sys.executable, __file__, "--parent",
                              str(args.parent), "--measure",
                              str(trees[side])],
                             capture_output=True, text=True, check=True)
        times[side].append(json.loads(out.stdout.splitlines()[-1]))
        print(f"turn {side}: {times[side][-1]}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    for case in times["this"][0]:
        med = {side: statistics.median(t[case] for t in times[side])
               for side in trees}
        print(f"{case}: parent {med['parent']:.4f} ms, this tree "
              f"{med['this']:.4f} ms a call (median of {args.turns} turns; "
              f"{card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
