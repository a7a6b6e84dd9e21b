#!/usr/bin/env python3
"""The ``flash_attention`` CUDA kernel of this tree against another source of
it (the kernel of an earlier commit, say), on one NVIDIA card.

    git show <commit>:src/repro_torch/kernels/csrc/flash_attention.cu \\
        > build/parent_flash_attention.cu
    python3 attention_ab.py --parent build/parent_flash_attention.cu

The other source is built with this tree's ``nvcc`` flags into
``build/kernels/probe/`` and called through its own C entry point, which
may lack this tree's ``prefix`` argument (sources before it lack it;
pass ``--prefix-arg`` for later ones).  At each
shape of ``SHAPES`` (the causal ones of ``chip_smoke.py``'s attention phase,
from bf16 inputs made from seed 0) it says whether the two outputs are
bit-equal and times both with ``chip_smoke.event_ms`` in turns (other,
this, this, other, other, this).  Prints the card's name and power limit
first.  Exits non-zero without a card or if a build or launch fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (name, (B, S, H, KV, dh, window)): causal attention at danube's serving
# shape and at S 8192, then the other compiled head dims.
SHAPES = (("serve", (8, 2048, 32, 8, 80, 4096)),
          ("long", (1, 8192, 32, 8, 80, 4096)),
          ("dh64", (8, 2048, 8, 8, 64, None)),
          ("dh128", (8, 2048, 16, 8, 128, None)))
TURNS = ("other", "this", "this", "other", "other", "this")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="another flash_attention.cu of the same C interface")
    ap.add_argument("--prefix-arg", action="store_true",
                    help="the other source's entry point takes a prefix")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    out = build.BUILD_DIR / "probe" / "libflash_attention_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.flags("flash_attention"), "-o",
                    str(out), str(args.parent)], check=True)
    lib = ctypes.CDLL(str(out))
    ints = 3 if args.prefix_arg else 2
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int64)] * 2
        + [ctypes.c_int] * ints + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int

    def other(q, k, v, window):
        B, Sq, H, dh = q.shape
        o = torch.empty_like(q)
        shape = (ctypes.c_int64 * 6)(B, H, k.shape[2], Sq, k.shape[1], dh)
        strides = (ctypes.c_int64 * 12)(*(
            s for t in (q, k, v, o) for s in (t.stride(0), t.stride(1),
                                              t.stride(2))))
        flags = (1, int(window or 0), 0)[:ints]
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), shape,
            strides, *flags, float(dh ** -0.5),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other kernel's launch failed: {rc}")
        return o

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, (B, S, H, KV, dh, window) in SHAPES:
        q, k, v = (torch.randn((B, S, n, dh), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for n in (H, KV, KV))
        calls = {"other": lambda: other(q, k, v, window),
                 "this": lambda: fa.flash_attention_cuda(
                     q, k, v, causal=True, window=window)}
        same = bool(torch.equal(calls["other"](), calls["this"]()))
        times = {"other": [], "this": []}
        for turn in TURNS:
            times[turn].append(chip_smoke.event_ms(torch, calls[turn], 20))
        results[name] = {"bit_equal": same, **times}
        print(f"attention_ab {name}: B {B} S {S} H {H} KV {KV} dh {dh} "
              f"causal window {window}: outputs bit-equal {same}; other "
              f"{['%.4f' % t for t in times['other']]} ms, this "
              f"{['%.4f' % t for t in times['this']]} ms", flush=True)
        del q, k, v
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
