#!/usr/bin/env python3
"""The ``flash_attention`` CUDA kernel of this tree against another source of
it (the kernel of an earlier commit, say), on one NVIDIA card; also its
backward, and the SSD forward's serving instantiation.

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
moves them).

    git show <commit>:src/repro_torch/kernels/csrc/flash_attention_bwd.cu \\
        > build/parent_flash_attention_bwd.cu
    python3 attention_ab.py --bwd-parent build/parent_flash_attention_bwd.cu

``--bwd-parent`` does the same for the backward: the other
``flash_attention_bwd.cu`` is built with this tree's flags, and both C
entry points get the same arguments (q, k, v, o, dO and lse, o and lse
from this tree's forward, and one scratch as large as either side needs)
at the causal shapes of ``BWD_SHAPES`` (from ``chip_smoke.ATTN_BWD_SHAPES``,
q scaled as there), timed in ``TURNS``.  It prints each side's medians,
each side's normalised error of dq, dk and dv against
``flash_attention_bwd_plain`` (bit-equality with the other side is not
expected: the two sum in other orders), whether two calls of a side are
bit-equal, the time of ``scaled_dot_product_attention``'s backward on the
same inputs, and, where ``cuobjdump`` is found, how many ``HGMMA``,
``HMMA``, ``UTMALDG`` and ``UBLKCP`` instructions each backward kernel of
either build holds.

    git show <commit>:src/repro_torch/kernels/csrc/ssd_scan.cu \\
        > build/parent_ssd_scan.cu
    python3 attention_ab.py --ssd-parent build/parent_ssd_scan.cu

``--ssd-parent`` holds this tree's SSD forward without its chunk states
(the serving instantiation) against another ``ssd_scan.cu`` whose entry
point has no states pointer (pass ``--ssd-states-arg`` for a source whose
entry point takes one after the final state; it is passed null): outputs
bit-equal or not at
``chip_smoke.SSD_SHAPE``, times in ``TURNS``, and the instructions of the
two builds' ``ssd_fwd<64, 128>`` that differ.

    git show <commit>:src/repro_torch/kernels/csrc/ssd_scan_bwd.cu \\
        > build/parent_ssd_scan_bwd.cu
    python3 attention_ab.py --ssd-bwd-parent build/parent_ssd_scan_bwd.cu

``--ssd-bwd-parent`` times this tree's SSD backward against another
``ssd_scan_bwd.cu`` of the same C entry point, both built with this tree's
flags and called with the same arguments (x, b and c slices of one
activation, as the model passes them; the chunk states from this tree's
forward; P and N zero-padded as the wrapper pads them) at every shape of
``chip_smoke.SSD_BWD_SHAPES``, in ``TURNS``.  It prints each side's
medians, each launch's device time by kernel name (``torch.profiler``),
the two sides' normalised error against each other for dx, ddt, da, db,
dc and dinit (they sum in other orders, so bit-equality is not
expected), whether two calls of a side are bit-equal, and, where
``cuobjdump`` is found, the counts of ``SSD_BWD_OPCODES`` in each backward
kernel of either build.  The options may be given alone or together.  Prints the card's name and power limit first.  Exits
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
# The backward's causal shapes, by their names in chip_smoke.ATTN_BWD_SHAPES.
BWD_SHAPES = ("danube", "recurrentgemma", "internvl_prefix", "dh160_padded")
# SASS instructions counted in each backward kernel.
BWD_OPCODES = ("HGMMA", "HMMA", "UTMALDG", "UBLKCP")
# ... and in each SSD backward kernel: loads (TMA, bulk, cp.async, plain),
# products (wgmma, mma.sync), block barriers, shared-memory traffic.
SSD_BWD_OPCODES = ("UTMALDG", "UBLKCP", "LDGSTS", "LDG", "HGMMA", "HMMA",
                   "BAR", "LDSM", "LDS", "STS", "STG")


def sass(cuobjdump: str, lib: Path, pattern: str) -> list:
    """The instructions of the kernel of ``lib`` whose mangled name matches
    ``pattern``, addresses dropped and constant-bank offsets masked."""
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    for body in re.split(r"\n\s*Function : ", out)[1:]:
        name = body.split("\n", 1)[0]
        if re.search(pattern, name):
            return [re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][.]",
                           line.split("*/", 1)[1]).split(";")[0].strip()
                    for line in body.split("\n")
                    if re.match(r"\s*/\*[0-9a-f]{4,}\*/", line)]
    return []


def kernel_opcodes(cuobjdump: str, lib: Path, pattern: str,
                   label, opcodes=BWD_OPCODES) -> dict:
    """Per kernel of ``lib`` whose mangled name matches ``pattern``, by its
    ``label`` ("name<template arguments>"): how many instructions of each
    of ``opcodes`` it holds."""
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts = {}
    for body in re.split(r"\n\s*Function : ", out)[1:]:
        name = body.split("\n", 1)[0].strip()
        if re.search(pattern, name):
            ops = re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", body)
            counts["%s<%s>" % label(name)] = {
                op: sum(o == op for o in ops) for op in opcodes}
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="another flash_attention.cu of the same C interface")
    ap.add_argument("--bwd-parent", type=Path,
                    help="another flash_attention_bwd.cu of the same C "
                         "interface")
    ap.add_argument("--ssd-parent", type=Path,
                    help="another ssd_scan.cu, from before its chunk states "
                         "pointer")
    ap.add_argument("--ssd-bwd-parent", type=Path,
                    help="another ssd_scan_bwd.cu of the same C interface")
    ap.add_argument("--ssd-states-arg", action="store_true",
                    help="the other ssd_scan.cu's entry point takes a chunk "
                         "states pointer after the final state")
    ap.add_argument("--prefix-arg", action="store_true",
                    help="the other source's entry point takes a prefix")
    ap.add_argument("--lse-arg", action="store_true",
                    help="the other source's entry point takes an lse "
                         "pointer after o")
    args = ap.parse_args(argv)
    if (args.parent, args.bwd_parent, args.ssd_parent,
            args.ssd_bwd_parent) == (None,) * 4:
        ap.error("give --parent, --bwd-parent, --ssd-parent, "
                 "--ssd-bwd-parent or several")

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
    results = {}
    if args.parent is not None:
        forward_ab(args, torch, chip_smoke, build, fa, results)
    if args.bwd_parent is not None:
        backward_ab(args.bwd_parent, torch, chip_smoke, build, fa, results)
    if args.ssd_parent is not None:
        ssd_ab(args.ssd_parent, args.ssd_states_arg, torch, chip_smoke,
               build, results)
    if args.ssd_bwd_parent is not None:
        ssd_bwd_ab(args.ssd_bwd_parent, torch, chip_smoke, build, results)
    print(json.dumps(results), flush=True)
    return 0


def forward_ab(args, torch, chip_smoke, build, fa, results: dict):
    """This tree's forward kernel against ``args.parent`` at ``SHAPES``,
    then the two builds' SASS; into ``results``."""
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
        pattern = rf"flash_fwdILi{dh}ELb0E(Lb0E)?E"   # no prefix, no lse
        a = sass(cuobjdump, other_lib, pattern)
        b = sass(cuobjdump, this_lib, pattern)
        diff = [line for line in difflib.unified_diff(a, b, lineterm="", n=0)
                if line[:1] in "+-" and line[:3] not in ("+++", "---")]
        results[f"sass_dh{dh}"] = {"other": len(a), "this": len(b),
                                   "differing": len(diff)}
        print(f"attention_ab sass dh {dh}, no prefix, no lse: other "
              f"{len(a)} instructions, this {len(b)}, {len(diff)} lines "
              "differ (constant-bank offsets masked)", flush=True)


def backward_ab(parent: Path, torch, chip_smoke, build, fa, results: dict):
    """This tree's backward kernels against the ``flash_attention_bwd.cu``
    at ``parent`` at ``BWD_SHAPES``; into ``results``."""
    this_lib = build.build(("flash_attention_bwd",))["flash_attention_bwd"]
    other_lib = build.BUILD_DIR / "probe" / "libflash_attention_bwd_other.so"
    other_lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.flags("flash_attention_bwd"),
                    "-I", str(build.CSRC), "-o", str(other_lib), str(parent)],
                   check=True)
    libs = {"other": ctypes.CDLL(str(other_lib)),
            "this": ctypes.CDLL(str(this_lib))}
    for lib in libs.values():
        lib.flash_attention_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 10
            + [ctypes.POINTER(ctypes.c_int64)] * 2
            + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
    scratch_floats = libs["this"].flash_attention_bwd_scratch_floats
    scratch_floats.argtypes = [ctypes.c_int64] * 3
    scratch_floats.restype = ctypes.c_int64

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = {key: rest for key, *rest in chip_smoke.ATTN_BWD_SHAPES}
    for name in BWD_SHAPES:
        (B, Sq, Sk, H, KV, dh), causal, window, prefix = shapes[name]
        kdh = fa.kernel_head_dim(dh)
        q = torch.randn((B, Sq, H, dh), generator=gen, device=dev)
        q = (q * chip_smoke.ATTN_EDGE_Q_SCALE).to(torch.bfloat16)
        k, v = (torch.randn((B, Sk, KV, dh), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        do = torch.randn((B, Sq, H, dh), generator=gen,
                         device=dev).to(torch.bfloat16)
        o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                         prefix=prefix, return_lse=True)
        want = fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=causal, window=window,
            bidirectional_prefix=prefix)
        ins = [fa.pad_head_dim(t, kdh) for t in (q, k, v, o, do)]
        outs = {side: [torch.empty_like(t) for t in ins[:3]] for side in libs}
        scratch = torch.empty(max(scratch_floats(B, H, Sq), B * H * Sq),
                              dtype=torch.float32, device=dev)
        shape = (ctypes.c_int64 * 6)(B, H, KV, Sq, Sk, kdh)
        stream = torch.cuda.current_stream().cuda_stream

        def raw(side):
            """A call of one side's entry point, its arguments made once."""
            fn = libs[side].flash_attention_bwd_launch
            dq, dk, dv = outs[side]
            strides = (ctypes.c_int64 * 24)(*(
                s for t in (*ins, dq, dk, dv)
                for s in (t.stride(0), t.stride(1), t.stride(2))))
            ptrs = [t.data_ptr() for t in ins[:4]] + [
                ins[4].data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr()]

            def call():
                rc = fn(*ptrs, shape, strides, int(causal), int(window or 0),
                        int(prefix), float(dh ** -0.5), stream)
                if rc != 0:
                    raise RuntimeError(f"the {side} backward's launch "
                                       f"failed: {rc}")
            return call

        calls = {side: raw(side) for side in libs}
        errs, twice = {}, {}
        for side, call in calls.items():
            call()
            first = [t[..., :dh].clone() for t in outs[side]]
            call()
            twice[side] = all(torch.equal(a, t[..., :dh])
                              for a, t in zip(first, outs[side]))
            errs[side] = {n: chip_smoke.norm_err(a, b) for n, a, b in
                          zip(("dq", "dk", "dv"), first, want)}
            del first
        times = {"other": [], "this": []}
        for turn in TURNS:
            times[turn].append(chip_smoke.event_ms(torch, calls[turn], 5))
        med = {side: sorted(ts)[len(ts) // 2] for side, ts in times.items()}
        sdpa = chip_smoke.sdpa_bwd_ms(torch, q, k, v, do, causal, window,
                                      prefix)
        results[f"bwd_{name}"] = {"median_ms": med, "norm_errs": errs,
                                  "bit_equal_twice": twice, "sdpa_bwd_ms": sdpa,
                                  **times}
        print(f"attention_ab backward {name}: B {B} Sq {Sq} Sk {Sk} H {H} "
              f"KV {KV} dh {dh} (kernel dh {kdh}) causal window {window} "
              f"prefix {prefix}: "
              + "; ".join(f"{side} {['%.4f' % t for t in sorted(ts)]} ms "
                          f"(median {med[side]:.4f}), norm err "
                          + ", ".join(f"{n} {e:.3e}"
                                      for n, e in errs[side].items())
                          + f", two calls bit-equal {twice[side]}"
                          for side, ts in times.items())
              + f"; sdpa backward {sdpa} ms; this/other "
              f"{med['this'] / med['other']:.3f}", flush=True)
        del q, k, v, do, o, lse, want, ins, outs, scratch
        torch.cuda.empty_cache()

    cuobjdump = shutil.which("cuobjdump", path=str(Path(build.nvcc()).parent))
    if cuobjdump is not None:
        for side, lib in (("other", other_lib), ("this", this_lib)):
            counts = kernel_opcodes(cuobjdump, lib, r"flash_bwd_",
                                    chip_smoke.kernel_label)
            results[f"bwd_sass_{side}"] = counts
            for kernel, ops in counts.items():
                print(f"attention_ab sass {side} {kernel}: "
                      + ", ".join(f"{op} {n}" for op, n in ops.items()),
                      flush=True)


def ssd_ab(parent: Path, states_arg: bool, torch, chip_smoke, build,
           results: dict):
    """This tree's SSD forward kernel without its chunk states (the serving
    instantiation) against the ``ssd_scan.cu`` at ``parent`` (whose entry
    point takes a states pointer where ``states_arg``, passed null) at
    ``chip_smoke.SSD_SHAPE`` with x, b and c
    strided as the model passes them; then the two builds' SASS of that
    instantiation; into ``results``."""
    import math
    this_lib = build.build(("ssd_scan",))["ssd_scan"]
    other_lib = build.BUILD_DIR / "probe" / "libssd_scan_other.so"
    other_lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.flags("ssd_scan"), "-o",
                    str(other_lib), str(parent)], check=True)

    def entry(path, states_arg):
        fn = ctypes.CDLL(str(path)).ssd_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * (9 if states_arg else 8)
                       + [ctypes.POINTER(ctypes.c_int64)] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        return fn, states_arg

    entries = {"other": entry(other_lib, states_arg),
               "this": entry(this_lib, True)}
    B, S, H, P, N = chip_smoke.SSD_SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=gen,
                      device=dev).to(torch.bfloat16)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    lo, hi = chip_smoke.SSD_DT_RANGE
    dt0 = torch.logspace(math.log10(lo), math.log10(hi), H, device=dev)
    dt = torch.nn.functional.softplus(
        dt0 + torch.log(-torch.expm1(-dt0))
        + 0.5 * torch.randn((B, S, H), generator=gen, device=dev))
    a = -torch.linspace(*chip_smoke.SSD_A_RANGE, H, device=dev)
    outs = {side: (torch.empty((B, S, H, P), dtype=torch.bfloat16,
                               device=dev),
                   torch.empty((B, H, P, N), device=dev)) for side in entries}

    def raw(side):
        fn, states_arg = entries[side]
        y, fin = outs[side]
        shape = (ctypes.c_int64 * 5)(B, S, H, P, N)
        strides = (ctypes.c_int64 * 13)(
            x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
            dt.stride(2), b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            y.stride(0), y.stride(1), y.stride(2))
        ptrs = [x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), None, y.data_ptr(), fin.data_ptr()]
        ptrs += [None] if states_arg else []
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            rc = fn(*ptrs, shape, strides, stream)
            if rc != 0:
                raise RuntimeError(f"the {side} kernel's launch failed: {rc}")

        return call

    calls = {side: raw(side) for side in entries}
    for call in calls.values():
        call()
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for u, v in zip(outs["other"], outs["this"]))
    times = {"other": [], "this": []}
    for turn in TURNS:
        times[turn].append(chip_smoke.event_ms(torch, calls[turn], 20))
    med = {side: sorted(ts)[len(ts) // 2] for side, ts in times.items()}
    results["ssd"] = {"bit_equal": same, "median_ms": med, **times}
    print(f"attention_ab ssd forward: B {B} S {S} H {H} P {P} N {N}, no "
          f"chunk states: outputs bit-equal {same}; "
          + "; ".join(f"{side} {['%.4f' % t for t in sorted(ts)]} ms "
                      f"(median {med[side]:.4f})"
                      for side, ts in times.items()), flush=True)
    cuobjdump = shutil.which("cuobjdump", path=str(Path(build.nvcc()).parent))
    if cuobjdump is None:
        return
    pattern = r"ssd_fwdILi64ELi128E(Lb0E)?E"   # the serving instantiation
    one, two = sass(cuobjdump, other_lib, pattern), sass(cuobjdump, this_lib,
                                                         pattern)
    diff = [line for line in difflib.unified_diff(one, two, lineterm="", n=0)
            if line[:1] in "+-" and line[:3] not in ("+++", "---")]
    results["sass_ssd"] = {"other": len(one), "this": len(two),
                           "differing": len(diff)}
    print(f"attention_ab sass ssd_fwd<64, 128> without chunk states: other "
          f"{len(one)} instructions, this {len(two)}, {len(diff)} lines "
          "differ (constant-bank offsets masked)", flush=True)



def ssd_bwd_ab(parent: Path, torch, chip_smoke, build, results: dict):
    """This tree's SSD backward against the ``ssd_scan_bwd.cu`` at
    ``parent`` at every shape of ``chip_smoke.SSD_BWD_SHAPES``, then the two
    builds' SASS opcode counts; into ``results``."""
    from repro_torch.kernels import ssd_scan as ss
    this_lib = build.build(("ssd_scan_bwd",))["ssd_scan_bwd"]
    other_lib = build.BUILD_DIR / "probe" / "libssd_scan_bwd_other.so"
    other_lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.flags("ssd_scan_bwd"), "-I",
                    str(build.CSRC), "-o", str(other_lib), str(parent)],
                   check=True)
    libs = {"other": ctypes.CDLL(str(other_lib)),
            "this": ctypes.CDLL(str(this_lib))}
    for lib in libs.values():
        lib.ssd_scan_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.POINTER(ctypes.c_int64)] * 2
            + [ctypes.c_void_p])
        lib.ssd_scan_bwd_launch.restype = ctypes.c_int

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    KP, KN = ss.KERNEL_P, ss.KERNEL_N
    names = ("dx", "ddt", "da", "db", "dc", "dinit")
    for key, (B, S, H, P, N), with_init, with_dfinal in (
            chip_smoke.SSD_BWD_SHAPES):
        x, dt, a, b, c, init, dy, dfinal = chip_smoke.ssd_bwd_inputs(
            torch, gen, dev, B, S, H, P, N, with_init, with_dfinal)
        _, _, states = ss.ssd_scan_cuda(x, dt, a, b, c, init, states=True)
        x, b, c, dfinal = ss.pad_shape(x, b, c, dfinal)
        if P < KP:
            dy = torch.nn.functional.pad(dy, (0, KP - P))
        nc = ss.n_chunks(S)
        f32 = dict(dtype=torch.float32, device=dev)
        outs = {side: {
            "ds": torch.empty((B, nc, H, KP, KN), **f32),
            "dx": torch.empty((B, S, H, KP), dtype=torch.bfloat16,
                              device=dev),
            "ddt": torch.empty((B, S, H), **f32),
            "da": torch.empty((B, nc, H), **f32),
            "db": torch.empty((B, S, KN), dtype=torch.bfloat16, device=dev),
            "dc": torch.empty((B, S, KN), dtype=torch.bfloat16, device=dev),
            "dinit": torch.empty((B, H, KP, KN), **f32)} for side in libs}
        shape = (ctypes.c_int64 * 5)(B, S, H, KP, KN)
        strides = (ctypes.c_int64 * 13)(
            x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
            dt.stride(1), dt.stride(2), b.stride(0), b.stride(1),
            c.stride(0), c.stride(1), dy.stride(0), dy.stride(1),
            dy.stride(2))
        stream = torch.cuda.current_stream().cuda_stream

        def raw(side):
            """A call of one side's entry point, its arguments made once."""
            fn = libs[side].ssd_scan_bwd_launch
            ptrs = [x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                    c.data_ptr(), states.data_ptr(), dy.data_ptr(),
                    dfinal.data_ptr() if dfinal is not None else None] + [t.data_ptr() for t in outs[side].values()]

            def call():
                rc = fn(*ptrs, shape, strides, stream)
                if rc != 0:
                    raise RuntimeError(f"the {side} SSD backward's launch "
                                       f"failed: {rc}")
            return call

        def grads(side):
            o = outs[side]
            return (o["dx"][..., :P], o["ddt"], o["da"].sum(dim=(0, 1)),
                    o["db"][..., :N], o["dc"][..., :N],
                    o["dinit"][:, :, :P, :N])

        calls = {side: raw(side) for side in libs}
        twice, first = {}, {}
        for side, call in calls.items():
            call()
            first[side] = [t.clone() for t in grads(side)]
            call()
            twice[side] = all(torch.equal(u, v)
                              for u, v in zip(first[side], grads(side)))
        cross = {n: chip_smoke.norm_err(u, v) for n, u, v in
                 zip(names, first["this"], first["other"])
                 if n != "dinit" or with_init}
        del first
        times = {"other": [], "this": []}
        for turn in TURNS:
            times[turn].append(chip_smoke.event_ms(torch, calls[turn], 10))
        med = {side: sorted(ts)[len(ts) // 2] for side, ts in times.items()}
        split = {side: chip_smoke.device_ms(
            torch, calls[side], chip_smoke.SSD_BWD_KERNELS, 10)
            for side in libs}
        results[f"ssd_bwd_{key}"] = {
            "median_ms": med, "launch_ms": split, "norm_errs_this_vs_other":
            cross, "bit_equal_twice": twice, **times}
        print(f"attention_ab ssd backward {key}: B {B} S {S} H {H} P {P} N "
              f"{N} (run at {KP}, {KN}), initial state {with_init}, "
              f"final-state cotangent {with_dfinal}: "
              + "; ".join(f"{side} {['%.4f' % t for t in sorted(ts)]} ms "
                          f"(median {med[side]:.4f}; launches "
                          + ", ".join(f"{k} {v}"
                                      for k, v in split[side].items())
                          + f"), two calls bit-equal {twice[side]}"
                          for side, ts in times.items())
              + f"; this/other {med['this'] / med['other']:.3f}; this "
              "against other, norm err "
              + ", ".join(f"{n} {e:.3e}" for n, e in cross.items()),
              flush=True)
        del x, dt, a, b, c, init, dy, dfinal, states, outs
        torch.cuda.empty_cache()

    cuobjdump = shutil.which("cuobjdump", path=str(Path(build.nvcc()).parent))
    if cuobjdump is not None:
        for side, lib in (("other", other_lib), ("this", this_lib)):
            counts = kernel_opcodes(cuobjdump, lib, r"ssd_bwd_",
                                    chip_smoke.kernel_label, SSD_BWD_OPCODES)
            results[f"ssd_bwd_sass_{side}"] = counts
            for kernel, ops in counts.items():
                print(f"attention_ab sass {side} {kernel}: "
                      + ", ".join(f"{op} {n}" for op, n in ops.items()),
                      flush=True)


if __name__ == "__main__":
    sys.exit(main())
