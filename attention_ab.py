#!/usr/bin/env python3
"""The ``flash_attention`` CUDA kernel of this tree against another source of
it (the kernel of an earlier commit, say), on one NVIDIA card.

    git show <commit>:src/repro_torch/kernels/csrc/flash_attention.cu \\
        > build/parent_flash_attention.cu
    python3 attention_ab.py --parent build/parent_flash_attention.cu

The other source is built with this tree's ``nvcc`` flags into
``build/kernels/probe/``.  Both libraries are called the same way, through
their C entry points with arguments made once, so that the two sides'
times differ only by the kernels; the other entry point may lack this
tree's ``prefix`` argument (sources before it lack it; pass
``--prefix-arg`` for later ones) and its ``lse`` pointer (pass
``--lse-arg`` for sources that take it).  At each shape of ``SHAPES`` (the
causal ones of ``chip_smoke.py``'s attention phase, from bf16 inputs made
from seed 0) it says whether the two outputs are bit-equal and times both
with ``chip_smoke.event_ms`` in ``TURNS``, then this tree's kernel through
its Python wrapper, and writing the row log-sum-exp for the backward
("lse").  Where ``cuobjdump`` is found beside ``nvcc`` it also counts the
instructions of the two builds' kernels without a prefix at each head dim
that differ, with constant-bank offsets masked (an added kernel parameter
moves them).  Prints the card's name and power limit first.  Exits
non-zero without a card or if a build or launch fails.
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import json
import re
import shutil
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
TURNS = ("other", "this", "this", "other") * 4


def sass(cuobjdump: str, lib: Path, dh: int) -> list:
    """The instructions of ``flash_fwd<dh, false[, false]>`` in ``lib``,
    addresses dropped and constant-bank offsets masked."""
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    for body in re.split(r"\n\s*Function : ", out)[1:]:
        name = body.split("\n", 1)[0]
        if re.search(rf"flash_fwdILi{dh}ELb0E(Lb0E)?E", name):
            return [re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][.]",
                           line.split("*/", 1)[1]).split(";")[0].strip()
                    for line in body.split("\n")
                    if re.match(r"\s*/\*[0-9a-f]{4,}\*/", line)]
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="another flash_attention.cu of the same C interface")
    ap.add_argument("--prefix-arg", action="store_true",
                    help="the other source's entry point takes a prefix")
    ap.add_argument("--lse-arg", action="store_true",
                    help="the other source's entry point takes an lse "
                         "pointer after o")
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
    this_lib = build.build(("flash_attention",))["flash_attention"]
    other_lib = build.BUILD_DIR / "probe" / "libflash_attention_other.so"
    other_lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.flags("flash_attention"), "-o",
                    str(other_lib), str(args.parent)], check=True)

    def entry(path, lse_arg, prefix_arg):
        fn = ctypes.CDLL(str(path)).flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * (5 if lse_arg else 4)
                       + [ctypes.POINTER(ctypes.c_int64)] * 2
                       + [ctypes.c_int] * (3 if prefix_arg else 2)
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        return fn, lse_arg, prefix_arg

    entries = {"other": entry(other_lib, args.lse_arg, args.prefix_arg),
               "this": entry(this_lib, True, True)}

    def raw(side, q, k, v, o, window):
        """A call of one side's kernel, its arguments made once."""
        fn, lse_arg, prefix_arg = entries[side]
        B, Sq, H, dh = q.shape
        shape = (ctypes.c_int64 * 6)(B, H, k.shape[2], Sq, k.shape[1], dh)
        strides = (ctypes.c_int64 * 12)(*(
            s for t in (q, k, v, o) for s in (t.stride(0), t.stride(1),
                                              t.stride(2))))
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
        ptrs += [None] if lse_arg else []
        flags = (1, int(window or 0), 0)[:3 if prefix_arg else 2]
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            rc = fn(*ptrs, shape, strides, *flags, float(dh ** -0.5), stream)
            if rc != 0:
                raise RuntimeError(f"the {side} kernel's launch failed: {rc}")
            return o

        return call

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, (B, S, H, KV, dh, window) in SHAPES:
        q, k, v = (torch.randn((B, S, n, dh), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for n in (H, KV, KV))
        outs = {side: torch.empty_like(q) for side in entries}
        calls = {side: raw(side, q, k, v, outs[side], window)
                 for side in entries}
        same = bool(torch.equal(calls["other"](), calls["this"]()))
        times = {"other": [], "this": []}
        for turn in TURNS:
            times[turn].append(chip_smoke.event_ms(torch, calls[turn], 20))
        times["this_wrapper"] = [chip_smoke.event_ms(
            torch, lambda: fa.flash_attention_cuda(
                q, k, v, causal=True, window=window), 20)]
        times["lse"] = [chip_smoke.event_ms(
            torch, lambda: fa.flash_attention_cuda(
                q, k, v, causal=True, window=window, return_lse=True), 20)]
        med = {side: sorted(ts)[len(ts) // 2] for side, ts in times.items()}
        results[name] = {"bit_equal": same, "median_ms": med, **times}
        print(f"attention_ab {name}: B {B} S {S} H {H} KV {KV} dh {dh} "
              f"causal window {window}: outputs bit-equal {same}; "
              + "; ".join(f"{side} {['%.4f' % t for t in sorted(ts)]} ms "
                          f"(median {med[side]:.4f})"
                          for side, ts in times.items()), flush=True)
        del q, k, v, outs

    cuobjdump = shutil.which("cuobjdump", path=str(Path(build.nvcc()).parent))
    for dh in sorted({dh for _, (_, _, _, _, dh, _) in SHAPES}):
        if cuobjdump is None:
            break
        a, b = sass(cuobjdump, other_lib, dh), sass(cuobjdump, this_lib, dh)
        diff = [line for line in difflib.unified_diff(a, b, lineterm="", n=0)
                if line[:1] in "+-" and line[:3] not in ("+++", "---")]
        results[f"sass_dh{dh}"] = {"other": len(a), "this": len(b),
                                   "differing": len(diff)}
        print(f"attention_ab sass dh {dh}, no prefix, no lse: other "
              f"{len(a)} instructions, this {len(b)}, {len(diff)} lines "
              "differ (constant-bank offsets masked)", flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
