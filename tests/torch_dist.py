"""Rank programs of the port's sharded-step tests: gloo worlds of separate
processes (no fake in-process devices), on the CPU or sharing one card.

    python tests/torch_dist.py JOB RANK WORLD INIT_FILE WORKDIR [DEVICE]

Each rank joins a gloo world through ``file://INIT_FILE``, reads the
inputs its parent wrote with ``torch.save`` to ``WORKDIR/inputs.pt``, runs
``JOBS[JOB]`` and writes what it returns to ``WORKDIR/JOB_RANK.pt``.
:func:`run_world` starts the ranks of one world and collects them.  This
module imports no JAX: the parent test holds the results against the
JAX package.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 16, 4, 2
TRAIN_STEPS = (50, 51, 52)         # warmup 100: lr = peak * step / 100
TRAIN_LR = 1e-3
DEC_BATCH, DEC_PROMPT, DEC_NEW, DEC_MAXLEN = 4, 8, 4, 16
MOE_BATCH, MOE_SEQ = 4, 8
# sequence-parallel attention and the sequence-split KV cache
# (test_torch_seq_parallel): train at 48 (three steps) and 2048 (one step)
# over model = 3; serve one prompt of 12 into a cache of 24 positions,
# which splits over 2, 3 and 4 ranks
SP_SEQ, SP_LONG = 48, 2048
SP_BATCH, SP_PROMPT, SP_MAXLEN = 1, 12, 24


def run_world(job: str, world: int, workdir: Path, device: str = "cpu",
              timeout: float = 300.0):
    """Start ``world`` ranks of ``job`` and wait for all; returns what each
    rank returned, by rank.  A rank that fails fails the world (the others
    are stopped)."""
    return wait_world(start_world(job, world, workdir, device), timeout)


def start_world(job: str, world: int, workdir: Path, device: str = "cpu"):
    workdir = Path(workdir)
    init = workdir / f"{job}.init"
    if init.exists():
        init.unlink()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, job, str(r), str(world), str(init),
                               str(workdir), device], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return job, workdir, procs


def wait_world(started, timeout: float = 300.0):
    job, workdir, procs = started
    deadline = time.time() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"{job}: ranks {bad} failed\n" + "\n".join(
            f"--- rank {r} ---\n{log[-3000:]}" for r, log in enumerate(logs)))
    return [torch.load(workdir / f"{job}_{r}.pt", weights_only=False)
            for r in range(len(procs))]


# ---------------------------------------------------------------------------
# rank programs
# ---------------------------------------------------------------------------
def _mesh(shape, device):
    from repro_torch.launch.mesh import make_test_mesh
    return make_test_mesh(shape, ("data", "model"), backend="gloo", device_type=device)


def _to(t, device):
    from repro_torch import tree
    from repro_torch.core.nesting import NestedTensor

    def leaf(_, x):
        return x.to(device) if isinstance(x, (torch.Tensor, NestedTensor)) else x
    return tree.map_with_path(leaf, t)


def _copy(state):
    from repro_torch import tree
    return type(state)(state.step.clone(), *(
        tree.map_with_path(lambda _, x: x.detach().cpu().clone(), getattr(state, f))
        for f in ("m", "v", "master")))


@contextlib.contextmanager
def without_data_mean(mesh):
    """The control of the train checks: inside, the mean over the data axes
    (``comm.all_reduce`` with op "mean" on their group) returns this rank's
    own tensor, so the train step leaves the gradients' data-parallel
    average out (and reports this rank's own loss)."""
    from repro_torch.distributed import comm
    from repro_torch.distributed.sharding import dp_axes

    group, real = mesh.group(dp_axes(mesh)), comm.all_reduce

    def local(x, g, op="sum"):
        if op == "mean" and g is not None and g is group:
            return x.clone()
        return real(x, g, op)

    comm.all_reduce = local
    try:
        yield
    finally:
        comm.all_reduce = real


def train_run(p, mesh, control: bool = False):
    """Three sharded train steps of the reduced qwen2 -> (losses, the whole
    optimizer state after each step on rank 0); ``control``: without the
    data-axis gradient average."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import steps
    from repro_torch.distributed.sharding import gather_tree, local_shard, shard_tree
    from repro_torch.optim import adamw

    cfg = get_config("qwen2-1.5b").reduced()
    shape = ShapeConfig("t", "train", TRAIN_SEQ, TRAIN_BATCH, microbatch=TRAIN_MICRO)
    step, specs = steps.build_train_step(cfg, shape, mesh, peak_lr=TRAIN_LR)
    full = _to(p["train_params"], mesh.device)
    params = shard_tree(full, specs["params"], mesh)
    opt = shard_tree(adamw.init_state(full), specs["opt"], mesh)
    losses, states = [], []
    for s, batch in zip(TRAIN_STEPS, p["train_batches"]):
        batch = {k: local_shard(v.to(mesh.device), specs["batch"][k], mesh)
                 for k, v in batch.items()}
        with without_data_mean(mesh) if control else contextlib.nullcontext():
            params, opt, metrics = step(params, opt, batch, s)
        losses.append(float(metrics["loss"]))
        whole = gather_tree(opt, specs["opt"], mesh)   # (unsplit leaves: the live ones)
        states.append(_copy(whole) if mesh.coord(("data", "model")) == 0 else None)
    return {"loss": losses, "opt": states}


def remat_thread_run(p, mesh):
    """``loss_fn``'s gradients on the reduced qwen2 under a (2, 2) context,
    remat on: the backward inside the context, and from another thread
    after it (as autograd runs a CUDA backward, and with it the remat
    recompute, on its own device thread)."""
    import dataclasses
    import threading

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import steps
    from repro_torch.distributed.ctx import logical_rules
    from repro_torch.models import make_model

    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), dtype="bfloat16")
    assert cfg.remat
    shape = ShapeConfig("t", "train", TRAIN_SEQ, TRAIN_BATCH, microbatch=TRAIN_MICRO)
    rules = shd.logical_rules(cfg, shape, mesh)
    params = shd.shard_tree(p["train_params"], shd.param_pspecs(
        cfg, steps.abstract_params(cfg), mesh), mesh)
    bspec = shd.batch_pspecs(cfg, shape, mesh, True)
    batch = {k: shd.local_shard(v, bspec[k], mesh) for k, v in p["train_batches"][0].items()}
    model = make_model(cfg, device=mesh.device)
    out = {}
    for where in ("inside", "thread"):
        leaves = [x.detach().requires_grad_(True) for x in tree.leaves(params)]
        with logical_rules(mesh, rules):
            loss = model.loss_fn(tree.unflatten(params, leaves), batch)
            if where == "inside":
                out[where] = torch.autograd.grad(loss, leaves)
        if where == "thread":
            box = {}
            t = threading.Thread(target=lambda: box.update(g=torch.autograd.grad(loss, leaves)))
            t.start()
            t.join(120)
            out[where] = box["g"]
    return all(torch.equal(a, b) for a, b in zip(out["inside"], out["thread"]))


def _same_specs(a, b) -> bool:
    from repro_torch import tree
    from repro_torch.core.nesting import NestedTensor

    def flat(t):
        return [(k, (tuple(v.w_base), tuple(v.scale)) if isinstance(v, NestedTensor)
                 else tuple(v)) for k, v in tree.flatten_with_path(t)]
    return flat(a) == flat(b)


def serve_run(p, mesh, cfg, params_key, quant, device, counters: bool = False,
              rung=None, batch=DEC_BATCH, prompt=DEC_PROMPT, maxlen=DEC_MAXLEN,
              prompt_key="prompt"):
    """The sharded prefill of ``batch`` prompts (``p[prompt_key]``), then
    ``DEC_NEW`` greedy decode steps against a cache of ``maxlen`` positions
    -> this data rank's logits per step, its tokens, and the kernels'
    launch counts of the run (``counters``); ``rung`` stamps a nested
    tree's serving rung first."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import steps
    from repro_torch.distributed.sharding import local_shard, shard_tree
    from repro_torch.kernels import dispatch

    prefill, ps = steps.build_prefill_step(
        cfg, ShapeConfig("p", "prefill", prompt, batch), mesh, quant)
    decode, ds = steps.build_decode_step(
        cfg, ShapeConfig("d", "decode", maxlen, batch), mesh, quant)
    from repro_torch.core.nesting import set_tree_rung

    full = _to(p[params_key], device)
    if rung is not None:
        full = set_tree_rung(full, rung)
    params = shard_tree(full, ds["params"], mesh)
    pre_params = params if _same_specs(ps["params"], ds["params"]) else \
        shard_tree(full, ps["params"], mesh)
    toks = local_shard(p[prompt_key].to(device), ps["batch"]["tokens"], mesh)
    if counters:
        dispatch.reset_counters()
    logits, pcache = prefill(pre_params, {"tokens": toks})
    cache = shard_tree(ds["model"].make_cache(batch, maxlen), ds["cache"], mesh)
    steps.fill_decode_cache(cache, pcache, mesh, ps["cache"], ds["cache"])
    out = [logits[:, -1].cpu()]
    tok = logits[:, -1].argmax(-1)
    toks_out = [tok.cpu()]
    for _ in range(DEC_NEW):
        logits, cache = decode(params, {"tokens": tok[:, None]}, cache)
        out.append(logits[:, -1].cpu())
        tok = logits[:, -1].argmax(-1)
        toks_out.append(tok.cpu())
    res = {"logits": torch.stack(out), "tokens": torch.stack(toks_out),
           "data": mesh.coord("data")}
    if counters:
        res["counts"] = {n: (c.launches, c.plain_launches)
                         for n, c in dispatch.COUNTERS.items()}
    return res


def moe_run(p, mesh):
    """moe_ffn of the reduced dbrx's layer 0 on this data rank's tokens:
    capacity-dropped with its aux loss (training) and dropless; the
    groups this rank computed."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import steps
    from repro_torch.distributed.ctx import logical_rules
    from repro_torch.models import moe
    from repro_torch.models.model import layer_params

    cfg = get_config("dbrx-132b").reduced()
    shape = ShapeConfig("t", "train", MOE_SEQ, MOE_BATCH, microbatch=MOE_BATCH)
    rules = shd.logical_rules(cfg, shape, mesh)
    pspec = shd.param_pspecs(cfg, steps.abstract_params(cfg), mesh)
    params = shd.shard_tree(p["moe_params"], pspec, mesh)
    lp = layer_params(params["blocks"], 0)["moe"]
    x = shd.local_shard(p["moe_x"], shd.P(rules["batch"], None, None), mesh)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k,
              capacity_factor=cfg.capacity_factor, act=cfg.act)
    out = {"data": mesh.coord("data"), "model": mesh.coord("model"),
           "held": lp["experts"]["w_up"]["w"].shape[0]}
    with logical_rules(mesh, rules), moe.record_groups() as log:
        out["train"], out["aux"] = moe.moe_ffn(x, lp, dropless=False, **kw)
        out["serve"], _ = moe.moe_ffn(x, lp, dropless=True, want_aux=False, **kw)
    out["groups"] = [g.groups for g in log]
    return out


def moe_serve_run(p, mesh):
    """The reduced dbrx served sharded from its (4, 8) nested tree (experts
    replicated over model by ``_nested_pspecs``, computed by block)."""
    from repro_torch.configs import get_config
    return serve_run(p, mesh, get_config("dbrx-132b").reduced(), "moe_nested", "nested",
                     mesh.device)


def compress_run(p, rank):
    import torch.distributed as dist

    from repro_torch.distributed.grad_compress import compress_decompress
    g = p["compress_g"][rank]
    return compress_decompress(g, torch.zeros_like(g), dist.group.WORLD)


def ckpt_run(p, workdir, meshes):
    """Save a tree sharded on (2, 2); restore it onto (1, 4), (4, 1) and
    plainly."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import P, shard_tree

    tree_ = p["ckpt_tree"]
    specs = {"w": P("data", "model"), "b": P()}
    mgr = CheckpointManager(str(Path(workdir) / "ckpt"))
    mgr.save(1, shard_tree(tree_, specs, meshes[(2, 2)]), extra={"mesh": "2x2"},
             mesh=meshes[(2, 2)], pspecs=specs)
    tmpl = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in tree_.items()}
    out = {}
    for shape in ((1, 4), (4, 1)):
        m = meshes[shape]
        got, manifest = mgr.restore(tmpl, mesh=m, pspecs=specs)
        out[shape] = {"tree": got, "coord": (m.coord("data"), m.coord("model")),
                      "extra": manifest["extra"]}
    out["plain"] = mgr.restore(tmpl, device="cpu")[0]
    return out


@contextlib.contextmanager
def _swapped(module, name, fn):
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, real)


def without_kv_grad_sum():
    """The control of the sequence-parallel train checks: k and v keep each
    rank's own gradient part (no sum over model)."""
    from repro_torch.models import model
    return _swapped(model, "_kv_grad_sum", lambda t: t)


def without_combine():
    """The control of the sequence-split cache checks: each rank's softmax
    over its own block of positions (the other blocks' pieces are not
    gathered)."""
    from repro_torch.models import attention
    return _swapped(attention, "_gather_blocks", lambda x, group: x[None])


def without_norm_sum():
    """The control of the ssm checks: the gated norm's sum of squares over
    this rank's block of d_inner alone (no sum over model)."""
    from repro_torch.models import mamba2
    return _swapped(mamba2, "_norm_sum", lambda ss: ss)


def sharded_train(p, mesh, cfg, params_key, batches_key, shape, control=None):
    """Sharded train steps of ``cfg`` from ``p[params_key]``, one per batch
    of ``p[batches_key]`` at ``TRAIN_STEPS`` -> (losses, the whole optimizer
    state after each step on rank 0), ``control`` (a context manager
    factory) around each step."""
    from repro_torch.distributed import steps
    from repro_torch.distributed.sharding import gather_tree, local_shard, shard_tree
    from repro_torch.optim import adamw

    step, specs = steps.build_train_step(cfg, shape, mesh, peak_lr=TRAIN_LR)
    full = _to(p[params_key], mesh.device)
    params = shard_tree(full, specs["params"], mesh)
    opt = shard_tree(adamw.init_state(full), specs["opt"], mesh)
    losses, states = [], []
    for s, batch in zip(TRAIN_STEPS, p[batches_key]):
        batch = {k: local_shard(v.to(mesh.device), specs["batch"][k], mesh)
                 for k, v in batch.items()}
        with control() if control else contextlib.nullcontext():
            params, opt, metrics = step(params, opt, batch, s)
        losses.append(float(metrics["loss"]))
        whole = gather_tree(opt, specs["opt"], mesh)
        states.append(_copy(whole) if mesh.coord(("data", "model")) == 0 else None)
    return {"loss": losses, "opt": states}


def _sp_serve(p, mesh, cfg, params_key, control=None):
    kw = dict(batch=SP_BATCH, prompt=SP_PROMPT, maxlen=SP_MAXLEN, prompt_key="sp_prompt")
    with control() if control else contextlib.nullcontext():
        return serve_run(p, mesh, cfg, params_key, None, mesh.device, **kw)


def sp_config(heads=4, kv_heads=2):
    """The reduced qwen2 (4 heads, 2 kv heads of 16) or a variant."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen2-1.5b").reduced(), num_heads=heads,
                               num_kv_heads=kv_heads)


def job_seq3(p, rank, workdir, device):
    """4 heads over model = 3: sequence-parallel train (and its control
    without the k/v gradient sum) at 48 and 2048, and the serve whose cache
    splits over model."""
    from repro_torch.configs.base import ShapeConfig
    mesh = _mesh((1, 3), device)
    cfg = sp_config()
    short = ShapeConfig("t", "train", SP_SEQ, TRAIN_BATCH, microbatch=TRAIN_MICRO)
    long = ShapeConfig("t", "train", SP_LONG, 1, microbatch=1)
    return {"train": sharded_train(p, mesh, cfg, "train_params", "sp_batches", short),
            "train_control": sharded_train(p, mesh, cfg, "train_params", "sp_batches", short,
                                           without_kv_grad_sum),
            "train_long": sharded_train(p, mesh, cfg, "train_params", "sp_long_batches", long),
            "serve": _sp_serve(p, mesh, cfg, "dense"),
            "serve_control": _sp_serve(p, mesh, cfg, "dense", without_combine)}


def job_seq4(p, rank, workdir, device):
    """The cache split over model on (1, 4) (4 heads: head-TP, 2 kv heads
    kept whole) and over (data, model) on (2, 2) (6 heads, 3 kv heads)."""
    m14, m22 = _mesh((1, 4), device), _mesh((2, 2), device)
    return {"model": _sp_serve(p, m14, sp_config(), "dense"),
            "data_model": _sp_serve(p, m22, sp_config(6, 3), "dense63"),
            "data_model_control": _sp_serve(p, m22, sp_config(6, 3), "dense63",
                                            without_combine)}


def job_seq2(p, rank, workdir, device):
    """The cache split over data on (2, 1): one prompt on both data ranks."""
    return {"data": _sp_serve(p, _mesh((2, 1), device), sp_config(), "dense")}


def ssm_runs(p, mesh, arch, control: bool, device):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("t", "train", TRAIN_SEQ, TRAIN_BATCH, microbatch=TRAIN_MICRO)
    out = {"train": sharded_train(p, mesh, cfg, f"{arch}/train_params", "ssm_batches", shape),
           "serve": serve_run(p, mesh, cfg, f"{arch}/dense", None, device)}
    if control:
        out["train_control"] = sharded_train(p, mesh, cfg, f"{arch}/train_params",
                                             "ssm_batches", shape, without_norm_sum)
        with without_norm_sum():
            out["serve_control"] = serve_run(p, mesh, cfg, f"{arch}/dense", None, device)
    return out


def ssm_ckpt_run(p, workdir, meshes, arch):
    """The arch's dense tree saved sharded as the train step lays it out on
    (2, 2); restored onto (1, 4) and plainly."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import steps
    from repro_torch.distributed.sharding import shard_tree

    cfg = get_config(arch).reduced()
    shape = ShapeConfig("t", "train", TRAIN_SEQ, TRAIN_BATCH, microbatch=TRAIN_MICRO)
    full = p[f"{arch}/train_params"]
    specs = {s: steps.build_train_step(cfg, shape, meshes[s])[1]["params"]
             for s in ((2, 2), (1, 4))}
    mgr = CheckpointManager(str(Path(workdir) / f"ckpt_{arch}"))
    mgr.save(1, shard_tree(full, specs[(2, 2)], meshes[(2, 2)]), mesh=meshes[(2, 2)],
             pspecs=specs[(2, 2)])
    tmpl = steps.abstract_params(dataclasses_bf16(cfg))
    got, _ = mgr.restore(tmpl, mesh=meshes[(1, 4)], pspecs=specs[(1, 4)])
    want = shard_tree(full, specs[(1, 4)], meshes[(1, 4)])
    from repro_torch import tree
    onto = all(torch.equal(a, b) for a, b in zip(tree.leaves(got), tree.leaves(want)))
    plain = mgr.restore(tmpl, device="cpu")[0]
    whole = all(torch.equal(a, b) for a, b in zip(tree.leaves(plain), tree.leaves(full)))
    split = [tuple(a.shape) != tuple(b.shape)
             for a, b in zip(tree.leaves(got), tree.leaves(full))]
    return {"onto_1x4": onto, "plain": whole, "leaves": len(split), "split": sum(split)}


def dataclasses_bf16(cfg):
    import dataclasses
    return dataclasses.replace(cfg, dtype="bfloat16")


def job_ssm4(p, rank, workdir, device):
    """mamba2 and zamba2 (reduced) train and serve on (2, 2) and (1, 4),
    the controls on (2, 2), the checkpoint re-shard."""
    meshes = {s: _mesh(s, device) for s in ((2, 2), (1, 4))}
    out = {}
    for arch in ("mamba2-780m", "zamba2-2.7b"):
        for shape, m in meshes.items():
            out[(arch, shape)] = ssm_runs(p, m, arch, shape == (2, 2), device)
        out[(arch, "ckpt")] = ssm_ckpt_run(p, workdir, meshes, arch)
    return out


def step_comm(mesh, cfg, device, seq=TRAIN_SEQ):
    """The collectives (``comm.counts()``) of one sharded train step of
    ``cfg`` (``TRAIN_BATCH`` x ``seq`` in microbatches of ``TRAIN_MICRO``)
    from a seeded init: what the dry run of the step must count."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import comm, steps
    from repro_torch.distributed.sharding import local_shard, shard_tree
    from repro_torch.launch.train import to_device
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw

    shape = ShapeConfig("t", "train", seq, TRAIN_BATCH, microbatch=TRAIN_MICRO)
    step, specs = steps.build_train_step(cfg, shape, mesh)
    full = init_params(dataclasses.replace(cfg, dtype="bfloat16"), seed=0, device=device)
    params = shard_tree(full, specs["params"], mesh)
    opt = adamw.init_state(params)
    batch = to_device(SyntheticLM(DataConfig(cfg.vocab_size, seq, TRAIN_BATCH), 0, 1).batch(0),
                      device)
    batch = {k: local_shard(v, specs["batch"][k], mesh) for k, v in batch.items()}
    comm.reset_counts()
    step(params, opt, batch, TRAIN_STEPS[0])
    return comm.counts()


def job_cpu4(p, rank, workdir, device):
    from repro_torch.configs import get_config
    from repro_torch.distributed import comm

    meshes = {s: _mesh(s, device) for s in ((2, 2), (1, 4), (4, 1))}
    m22 = meshes[(2, 2)]
    comm.reset_counts()
    out = {"train_2x2": train_run(p, m22)}
    out["train_comm"] = comm.counts()
    out["train_2x2_control"] = train_run(p, m22, control=True)
    out["train_1x4"] = train_run(p, meshes[(1, 4)])
    out["remat_thread"] = remat_thread_run(p, m22)
    cfg = get_config("qwen2-1.5b").reduced()
    out["decode"] = serve_run(p, m22, cfg, "dense", None, device)
    out["decode_nested"] = serve_run(p, m22, cfg, "nested", "nested", device)
    out["moe"] = moe_run(p, m22)
    out["moe_serve"] = moe_serve_run(p, m22)
    out["compress"] = compress_run(p, rank)
    out["ckpt"] = ckpt_run(p, workdir, meshes)
    # one step's collectives, for the dry run: head-TP on (2, 2), and
    # sequence-parallel attention on (1, 4) (6 heads do not divide 4)
    out["step_comm"] = {"train_2x2": step_comm(m22, cfg, device),
                        "seq_1x4": step_comm(meshes[(1, 4)], sp_config(6, 3), device)}
    return out


def job_cpu2(p, rank, workdir, device):
    return {"train_2x1": train_run(p, _mesh((2, 1), device))}


def job_gpu2(p, rank, workdir, device):
    """The reduced qwen2's nested serve over model = 2 on one card, at
    rungs 0 and 1."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-1.5b").reduced()
    mesh = _mesh((1, 2), device)
    return {rung: serve_run(p, mesh, cfg, "nested", "nested", device, counters=True,
                            rung=rung) for rung in (0, 1)}


JOBS = {"cpu4": job_cpu4, "cpu2": job_cpu2, "gpu2": job_gpu2, "seq3": job_seq3,
        "seq4": job_seq4, "seq2": job_seq2, "ssm4": job_ssm4}


def main(argv) -> int:
    job, rank, world, init, workdir = argv[:5]
    device = argv[5] if len(argv) > 5 else "cpu"
    rank, world = int(rank), int(world)
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world

    torch.manual_seed(0)
    init_world("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    try:
        p = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
        out = JOBS[job](p, rank, workdir, device)
        torch.save(out, Path(workdir) / f"{job}_{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
