"""Several gloo ranks on the CPU for the port's multi-device tests.

``run_ranks(fn, world, workdir, *args)`` spawns ``world`` processes, each
joining a gloo process group over a ``file://`` store in ``workdir`` (no
TCP port, so tests under pytest-xdist never collide), runs
``fn(rank, world, *args)`` with one torch thread, and returns each rank's
result.  Every wait has a deadline: a hung collective fails the test
instead of the run.  This module imports torch and the port only, so the
spawned ranks never load JAX; the rank functions below are what the
``tests/test_torch_*`` files run in them.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils import _pytree as pytree

from repro_torch import partition
from repro_torch.launch.mesh import make_host_mesh


def _entry(rank, fn, world, workdir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, workdir, *args, timeout: float = 120.0):
    """``[fn(r, world, *args) for r in range(world)]``, each in its own
    gloo rank; raises on a rank's error and after ``timeout`` seconds."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(fn, world, workdir, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _mesh(data: int, model: int):
    return make_host_mesh(data=data, model=model, device="cpu")


def _full(tree):
    """Every leaf of ``tree`` as a whole plain tensor (DTensors gathered)."""
    return pytree.tree_map(
        lambda t: t.full_tensor() if partition.is_dtensor(t) else t, tree)


# ---------------------------------------------------------------------------
# Sequence-sharded flash-decode.
# ---------------------------------------------------------------------------


def decode_rank(rank, world, cases, dtype):
    """The sharded decode and cache insert on this rank's slice of a cache
    against the unsharded port on the whole cache, for each of ``cases``
    (name -> (B, H, KV, dh, W, cache_len, window, insert positions,
    seed)), with the attention's compute dtype set to ``dtype`` in this
    process."""
    from repro_torch.models import attention as attn
    attn.COMPUTE_DTYPE = getattr(torch, dtype)
    out = {}
    for name, case in cases.items():
        B, H, KV, dh, W, cache_len, window, inserts, seed = case
        g = torch.Generator().manual_seed(seed)
        q = torch.randn((B, H, dh), generator=g)
        k = torch.randn((B, W, KV, dh), generator=g)
        v = torch.randn((B, W, KV, dh), generator=g)
        news = [torch.randn((B, KV, dh), generator=g) for _ in inserts]
        want_k = k.clone()
        for pos, new in zip(inserts, news):
            attn.cache_insert(want_k, new, pos, ring=W)
        want = attn.decode_attention_sharded(q, want_k, v, cache_len, window)
        rules = partition.serve_rules(_mesh(1, world), B)
        with partition.use_rules(rules):
            s = attn.local_window(W)
            got_k = k[:, rank * s:(rank + 1) * s].clone()
            got_v = v[:, rank * s:(rank + 1) * s].clone()
            for pos, new in zip(inserts, news):
                attn.cache_insert(got_k, new, pos, ring=W)
            got = attn.decode_attention_sharded(q, got_k, got_v, cache_len,
                                                window)
        parts = [torch.empty_like(got_k) for _ in range(world)]
        dist.all_gather(parts, got_k)
        out[name] = {"out": got, "want": want,
                     "cache": torch.cat(parts, dim=1), "want_cache": want_k}
    return out


def serve_rank(rank, world, arch, arrays, tokens, extras, s0, max_seq):
    """A reduced ``arch``, its parameters carried across from the JAX
    package's (``arrays``), served under ``serve_rules`` on a (1, world)
    mesh: the logits of the prefill (``tokens[:, :s0]`` and ``extras``, the
    vlm patch embeddings or encdec frames) and of each decode step through
    the ``Server``'s weights, the whole vocab's (``Model.whole_logits``:
    each rank computes its vocab columns), and a ``Server.run``'s
    tokens."""
    from repro_torch.configs import get_config
    from repro_torch.convert import model_params_from_arrays
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models.model import Model
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu")
    rules = partition.serve_rules(_mesh(1, world), tokens.shape[0])
    with partition.use_rules(rules):
        params = partition.place(
            model_params_from_arrays(cfg, arrays, device="cpu"),
            partition.param_shardings(rules, model.param_axes()))
        srv = Server(model, params, tokens.shape[0], max_seq=max_seq,
                     device="cpu")
        tok = torch.from_numpy(tokens)
        batch = {"tokens": tok[:, :s0],
                 **{k: torch.from_numpy(v).to(torch.bfloat16)
                    for k, v in extras.items()}}
        logits, cache = model.prefill(srv.params, batch, max_seq=max_seq)
        out = [model.whole_logits(logits)]
        for t in range(s0, tokens.shape[1]):
            logits, cache = model.decode_step(srv.params, cache, tok[:, t], t)
            out.append(model.whole_logits(logits))
        reqs = [Request(rid=i, prompt=tokens[i, :s0], max_new=4)
                for i in range(tokens.shape[0])]
        stats = srv.run(reqs)
    placed = [str(t.placements) for t in pytree.tree_leaves(params)]
    return {"logits": [x.numpy() for x in out],
            "kv_positions": [t.shape[-3] for name, t in _paths(cache)
                             if name.rsplit("/", 1)[-1] in ("k", "v")],
            "new_tokens": stats["new_tokens"], "placements": placed}


def _paths(tree, prefix=""):
    """(path, tensor) pairs of a nested cache."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# Training state: sharded init, elastic restore, the data-parallel step.
# ---------------------------------------------------------------------------


def elastic_rank(rank, world, ckdir):
    """A reduced h2o-danube-1.8b ``TrainState`` initialised under
    ``fsdp_rules`` on a (2, 2) mesh against the unsharded init; saved, then
    restored onto a (4, 1) mesh with that mesh's shardings; and a plain
    one-device checkpoint restored onto the mesh."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import init_state, make_state_axes
    model = Model(get_config("h2o-danube-1.8b").reduced(), device="cpu")
    opt = AdamW()
    plain = init_state(model, opt, 7)
    rules = partition.fsdp_rules(_mesh(2, 2), 8)
    with partition.use_rules(rules):
        state = init_state(model, opt, 7)
    leaves = pytree.tree_leaves(state)
    sharded = [str(t.placements) for t in leaves]
    saved = [t.clone() for t in pytree.tree_leaves(_full(state))]
    init_equal = all(torch.equal(a, b) for a, b in
                     zip(saved, pytree.tree_leaves(plain)))
    store = CheckpointStore(os.path.join(ckdir, "mesh"))
    store.save(3, state, blocking=True)

    rules = partition.fsdp_rules(_mesh(4, 1), 8)
    sh = partition.param_shardings(
        rules, make_state_axes(model.param_axes()))
    with partition.use_rules(rules):
        like = init_state(model, opt, 0)
    got, step = store.restore(like, shardings=sh)
    got_leaves = pytree.tree_leaves(got)
    placed = [str(t.placements) for t in got_leaves]
    want_placed = [str(s.placements) for s in pytree.tree_flatten(
        sh, is_leaf=lambda s: isinstance(s, partition.Sharding))[0]]
    restored_equal = all(torch.equal(a, b) for a, b in
                         zip(pytree.tree_leaves(_full(got)), saved))

    plain_store = CheckpointStore(os.path.join(ckdir, "plain"))
    plain_store.save(5, plain, blocking=True)
    onto_mesh, step_plain = plain_store.restore(like, shardings=sh)
    plain_equal = all(torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves(_full(onto_mesh)), pytree.tree_leaves(plain)))
    back, _ = store.restore(plain)        # the mesh's checkpoint, no mesh
    back_equal = all(torch.equal(a, b) and not partition.is_dtensor(a)
                     for a, b in zip(pytree.tree_leaves(back), saved))
    return {"init_equal": init_equal, "sharded": sharded,
            "restored_equal": restored_equal, "step": step,
            "placed": placed, "want_placed": want_placed,
            "plain_onto_mesh_equal": plain_equal, "step_plain": step_plain,
            "mesh_onto_plain_equal": back_equal}


class _SpyOptimizer:
    """An optimizer that records, as whole tensors, the gradients the train
    step hands its ``update``, then updates as ``opt`` does."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads.append([g.clone() for g in pytree.tree_leaves(_full(grads))])
        return self.opt.update(grads, state, params)


def train_rank(rank, world, arch, batches, data):
    """Train steps of a reduced ``arch`` under ``fsdp_rules`` on a
    (``data``, world // ``data``) mesh, each rank on its shard of each of
    ``batches``, against the one-process steps on the whole batches: each
    step's loss and gradient norm, the gradients ``make_train_step`` hands
    the optimizer, and each parameter's change over the steps, as whole
    tensors."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import init_state, make_train_step
    model = Model(get_config(arch).reduced(), device="cpu")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in batches]

    def run(rules):
        opt = _SpyOptimizer(AdamW(learning_rate=1e-3))
        with partition.use_rules(rules):
            state = init_state(model, opt, 0)
            before = [t.clone() for t in pytree.tree_leaves(
                _full(state.params))]
            step = make_train_step(model, opt,
                                   param_axes=model.param_axes())
            metrics = []
            for b in batches:
                state, m = step(state, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            after = pytree.tree_leaves(_full(state.params))
        return metrics, opt.grads, [a - b for a, b in zip(after, before)]

    one = run(None)
    sharded = run(partition.fsdp_rules(_mesh(data, world // data),
                                       batches[0]["tokens"].shape[0]))
    return {"one": one, "sharded": sharded}


def launch_rank(rank, world, which, argv):
    """``repro_torch.launch.<which>.main(argv)`` on this rank: the launcher
    finds the process group running and builds its mesh over every rank."""
    import importlib
    out = importlib.import_module(f"repro_torch.launch.{which}").main(argv)
    if which == "train":
        return {"losses": out["losses"], "final_step": out["final_step"]}
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism on the model axis.
# ---------------------------------------------------------------------------


class _Shapes:
    """Records, while it is entered, the shapes each rank's kernels and
    model-axis weight reads run at: the attention's q and k, the SSD
    scan's x, and every split ``partition.wshard`` result by (axes,
    axis)."""

    def __init__(self):
        self.attn, self.ssd, self.shards = set(), set(), set()

    def __enter__(self):
        from repro_torch.models import attention, ssm
        self._saved = (attention.flash_attention_kernel, ssm.ssd_scan_kernel,
                       partition.wshard)
        attn_fn, ssd_fn, wshard = self._saved

        def attn(q, k, v, **kw):
            self.attn.add((tuple(q.shape), tuple(k.shape)))
            return attn_fn(q, k, v, **kw)

        def ssd(x, *args, **kw):
            self.ssd.add(tuple(x.shape))
            return ssd_fn(x, *args, **kw)

        def shard(x, dtype, axes, share):
            out = wshard(x, dtype, axes, share)
            if share.split:
                self.shards.add((tuple(axes), share.name, tuple(out.shape)))
            return out

        attention.flash_attention_kernel = attn
        ssm.ssd_scan_kernel = ssd
        partition.wshard = shard
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention, ssm
        (attention.flash_attention_kernel, ssm.ssd_scan_kernel,
         partition.wshard) = self._saved

    def record(self):
        return {"attn": sorted(self.attn), "ssd": sorted(self.ssd),
                "shards": sorted(self.shards, key=repr)}


def tp_rank(rank, world, data, cases):
    """Each of ``cases`` (a reduced architecture, the JAX package's
    parameters as numpy ``arrays``, prompt and teacher-forced ``tokens``,
    the family's ``extras``, the prompt length ``s0``, ``max_seq``, and a
    training ``batch``) on a (``data``, world // ``data``) mesh: served
    under ``serve_rules`` and ``fsdp_rules`` (the prefill's and each decode
    step's whole logits, the greedy tokens of ``Model.greedy`` and the
    argmax of the whole logits), then one train step under ``fsdp_rules``
    (its loss and grad norm, the gradients handed to the optimizer as
    whole tensors); each with the kernel and weight shapes this rank ran
    at and the blocks ``Rules.repeats`` counted."""
    from repro_torch.configs import get_config
    from repro_torch.convert import model_params_from_arrays
    from repro_torch.models.layers import serving_copy
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import (TrainState, make_train_step)
    mesh = _mesh(data, world // data)
    out = {}
    for case in cases:
        cfg = get_config(case["arch"]).reduced()
        model = Model(cfg, device="cpu")
        tok = torch.from_numpy(case["tokens"])
        B, s0 = tok.shape[0], case["s0"]
        res = {}
        for kind in ("serve", "fsdp"):
            rules = getattr(partition, f"{kind}_rules")(mesh, B)
            with partition.use_rules(rules), _Shapes() as shapes, \
                    torch.no_grad():
                params = serving_copy(partition.place(
                    model_params_from_arrays(cfg, case["arrays"],
                                             device="cpu"),
                    partition.param_shardings(rules, model.param_axes())))
                batch = {"tokens": tok[:, :s0],
                         **{k: torch.from_numpy(v).to(torch.bfloat16)
                            for k, v in case["extras"].items()}}
                logits, cache = model.prefill(params, batch,
                                              max_seq=case["max_seq"])
                steps = [logits]
                for t in range(s0, tok.shape[1]):
                    logits, cache = model.decode_step(params, cache,
                                                      tok[:, t], t)
                    steps.append(logits)
                whole = [model.whole_logits(x) for x in steps]
                res[kind] = {
                    "logits": [x.numpy() for x in whole],
                    "greedy": [model.greedy(x).numpy() for x in steps],
                    "argmax": [torch.argmax(x, -1).numpy() for x in whole],
                    "local_vocab": steps[0].shape[-1],
                    "repeats": dict(rules.repeats), **shapes.record()}
        rules = partition.fsdp_rules(mesh, case["batch"]["tokens"].shape[0])
        opt = _SpyOptimizer(AdamW(learning_rate=1e-3))
        with partition.use_rules(rules), _Shapes() as shapes:
            params = partition.place(
                model_params_from_arrays(cfg, case["arrays"], device="cpu"),
                partition.param_shardings(rules, model.param_axes()))
            state = TrainState(params, opt.init(params), torch.zeros(
                (), dtype=torch.int32))
            step = make_train_step(model, opt, param_axes=model.param_axes())
            _, m = step(state, {k: torch.from_numpy(v)
                                for k, v in case["batch"].items()})
        res["train"] = {"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "grads": opt.grads[0], "repeats": dict(rules.repeats),
                        **shapes.record()}
        out[case["arch"]] = res
    return out


def vocab_rank(rank, world, x, head, labels, mask, logits):
    """The vocab-parallel pieces on a (1, world) mesh, each rank holding
    its columns of the vocab: the chunked cross-entropy (with the pad
    columns from 40 masked) and its gradients of ``x`` and ``head``, and
    the cross-shard argmax of ``logits``."""
    from repro_torch.models.model import chunked_cross_entropy
    rules = partition.fsdp_rules(_mesh(1, world), x.shape[0])
    with partition.use_rules(rules):
        xg = x.clone().requires_grad_()
        hg = head.clone().requires_grad_()
        ce = chunked_cross_entropy(xg, hg, labels, mask, chunk=8,
                                   valid_vocab=40)
        dx, dh = torch.autograd.grad(ce, (xg, hg))
        share = partition.shard_of("vocab", logits.shape[-1])
        lo, hi = share.lo, share.hi
        top = partition.argmax_sharded(logits[:, lo:hi], share)
        repeats = dict(rules.repeats)
    return {"ce": ce.detach(), "dx": dx, "dhead": dh[:, lo:hi], "lo": lo,
            "hi": hi, "argmax": top, "repeats": repeats,
            "remat_in_a_thread": _remat_in_a_thread(world),
            "global_norm": _global_norm(world)}


def _global_norm(world):
    """``global_norm`` of a tree with a leaf sharded over the model axis,
    one replicated on it and a plain one, on (1, ``world``), against the
    norm of the whole leaves: (got, want)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.optim.adamw import global_norm
    g = torch.Generator().manual_seed(3)
    leaves = [torch.randn((6, 8), generator=g) for _ in range(3)]
    mesh = _mesh(1, world)
    tree = {"sharded": distribute_tensor(leaves[0], mesh,
                                         [Replicate(), Shard(1)]),
            "replicated": distribute_tensor(leaves[1], mesh,
                                            [Replicate(), Replicate()]),
            "plain": leaves[2]}
    want = torch.sqrt(sum(torch.sum(torch.square(x)) for x in leaves))
    return float(global_norm(tree)), float(want)


def _remat_in_a_thread(world):
    """A reduced danube's loss with per-layer remat under ``fsdp_rules`` on
    (1, ``world``), differentiated on this thread and on another thread
    that binds no rules (as the autograd engine's device thread runs a
    CUDA backward): whether the two gradients are equal."""
    import threading

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model import Model
    model = Model(get_config("h2o-danube-1.8b").reduced(), device="cpu")
    params = model.init(0)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMData.for_config(
        model.cfg, 32, 2, seed=0, mode="succ").batch(0).items()}
    rules = partition.fsdp_rules(_mesh(1, world), 2)
    grads = []
    for on_thread in (False, True):
        leaves, spec = pytree.tree_flatten(params)
        live = [t.detach().clone().requires_grad_() for t in leaves]
        with partition.use_rules(rules):
            loss, _ = model.loss_fn(pytree.tree_unflatten(live, spec), batch)
        if on_thread:
            t = threading.Thread(target=loss.backward)
            t.start()
            t.join(60)
        else:
            loss.backward()
        grads.append([x.grad for x in live])
    return all(a is not None and torch.equal(a, b)
               for a, b in zip(*grads))


def repeat_rank(rank, world, seed=0):
    """Each block whose dims a (1, ``world``) mesh does not divide, called
    under ``fsdp_rules`` on its placed weights and without rules on the
    same whole weights: per block, the largest difference of the output,
    of the input's gradient and of every weight's gradient (whole), each
    over the largest element of the rule-less one, and the blocks
    ``Rules.repeats`` counted."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention, moe, rglru, ssm
    from repro_torch.models.layers import (COMPUTE_DTYPE, AxesBuilder,
                                           ParamBuilder)
    blocks = {
        "rglru": ("recurrentgemma-2b", rglru.init_rglru_block,
                  lambda p, x, c: rglru.recurrent_block(p, x, c)),
        "rglru_decode": ("recurrentgemma-2b", rglru.init_rglru_block,
                         lambda p, x, c: rglru.recurrent_block_decode(
                             p, x[:, 0], c, rglru.init_rglru_state(
                                 c, x.shape[0]))[0]),
        "ssm": ("mamba2-370m", ssm.init_mamba2,
                lambda p, x, c: ssm.mamba2_block(p, x, c)),
        "ssm_decode": ("mamba2-370m", ssm.init_mamba2,
                       lambda p, x, c: ssm.mamba2_decode(
                           p, x[:, 0], c, ssm.init_mamba2_state(
                               c, x.shape[0]))[0]),
        "attention": ("h2o-danube-1.8b", attention.init_attention,
                      lambda p, x, c: attention.attention(
                          p, x, c, positions=torch.arange(x.shape[1])[None])),
        "moe": ("moonshot-v1-16b-a3b", moe.init_moe,
                lambda p, x, c: moe.moe_mlp(p, x, c)[0])}
    mesh = _mesh(1, world)
    out = {}
    for name, (arch, init, call) in blocks.items():
        cfg = get_config(arch).reduced()
        whole = init(ParamBuilder(seed, "cpu"), cfg)
        axes = init(AxesBuilder(), cfg)
        g = torch.Generator().manual_seed(seed + 1)
        x = torch.randn((2, 16, cfg.d_model), generator=g).to(COMPUTE_DTYPE)
        runs = []
        for rules in (None, partition.fsdp_rules(mesh, 2)):
            with partition.use_rules(rules):
                params = whole if rules is None else partition.place(
                    whole, partition.param_shardings(rules, axes))
                leaves, spec = pytree.tree_flatten(params)
                live = [t.detach().clone().requires_grad_() for t in leaves]
                xg = x.clone().requires_grad_()
                y = call(pytree.tree_unflatten(live, spec), xg, cfg)
                ct = torch.randn(y.shape, generator=torch.Generator()
                                 .manual_seed(seed + 2)).to(y.dtype)
                grads = torch.autograd.grad(y, [xg] + live, ct)
            runs.append([y.detach()] + [
                t.full_tensor() if partition.is_dtensor(t) else t
                for t in grads])
            repeats = {} if rules is None else dict(rules.repeats)

        def rel(a, b):
            return float((a.float() - b.float()).abs().max()
                         / b.float().abs().max().clamp(min=1e-30))
        want, got = runs
        out[name] = {"out": rel(got[0], want[0]), "dx": rel(got[1], want[1]),
                     "dw": max(rel(a, b) for a, b in zip(got[2:], want[2:])),
                     "repeats": repeats}
    return out
