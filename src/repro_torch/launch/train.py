"""Fault-tolerant training CLI; counterpart of ``repro/launch/train.py``,
with its flags, behaviour and log lines.  Runs on the card unless
``--device cpu`` is given.

  * a stateless data cursor (``SyntheticLM``): a resumed run is bitwise
    the run that did not stop;
  * atomic checkpoints every ``--ckpt-every`` steps, the newest three kept;
    a run resumes from the newest, at its ``manifest["extra"]["data_step"]``;
  * a straggler watchdog: a step over ``--step-deadline-s`` is logged;
  * ``--simulate-failure-at N``: hard exit (code 42) before step N.

Usage (CPU-scale, the reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
      --steps 200 --ckpt-dir /tmp/ckpt --device cpu

Determinism.  The step is made deterministic, so that resuming is bitwise:
``torch.use_deterministic_algorithms(True)``, with cuBLAS's fixed-size
workspace (``CUBLAS_WORKSPACE_CONFIG=:4096:8``, set before the first CUDA
call; PyTorch refuses cuBLAS calls in deterministic mode without it).  Of
the ops this step runs on the card, PyTorch documents two as
nondeterministic by default, and the mode gives them deterministic
kernels: the backward of the embedding's row gather (``index_put_`` with
accumulate) and the backward of the cross entropy's gold-logit gather
(``scatter_add_``).  On an H100 neither showed it: a full-width two-layer
step's gradients repeat bit for bit without the mode as well
(``tests/test_torch_gpu.py::test_train_step_gradients_repeat_bit_for_bit``),
so no op was seen to need it; the mode keeps the guarantee.  K5 and the
blockwise attention backward are deterministic as written.

The weights are random, from the port's seeded ``Model.init`` (a
``torch.Generator`` on the device), so losses differ from the JAX
package's CLI and between devices.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..data import DataConfig, SyntheticLM
from ..models import make_model
from ..optim import adamw
from .. import tree


def make_train_step(model, *, peak_lr: float, warmup: int, total: int):
    """``step(params, opt, batch, step) -> (params, opt, metrics)``: the
    loss and its gradient in every leaf, the warmup-cosine learning rate of
    ``step``, one AdamW update; ``metrics`` holds ``loss``, ``lr`` and
    ``grad_norm`` as 0-d tensors (read them only when needed: each read
    waits for the device)."""
    def train_step(params, opt, batch, step):
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        loss = model.loss_fn(tree.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        lr = adamw.warmup_cosine(step, peak_lr=peak_lr, warmup=warmup, total=total)
        params, opt, metrics = adamw.apply_update(params, tree.unflatten(params, grads),
                                                  opt, lr=lr)
        metrics["loss"] = loss.detach()
        return params, opt, metrics
    return train_step


def to_device(batch, device):
    """A numpy batch on ``device``: token ids and labels int64, embeddings
    as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = (t.long() if k in ("tokens", "labels") else t).to(device)
    return out


def make_deterministic() -> None:
    """Deterministic kernels for the rest of the process; call before the
    first CUDA call (cuBLAS reads its workspace setting at start-up)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M-param runs)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--step-deadline-s", type=float, default=120.0)
    ap.add_argument("--simulate-failure-at", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    make_deterministic()

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)

    device = torch.device(args.device)
    model = make_model(cfg, device=device)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                  input_kind=cfg.input_kind, d_model=cfg.d_model))
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    train_step = make_train_step(model, peak_lr=args.lr, warmup=20, total=args.steps)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # ---- resume or init ----
    start = 0
    params = model.init(0)
    opt = adamw.init_state(params)
    if mgr.latest_step() is not None:
        restored, manifest = mgr.restore({"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        start = manifest["extra"]["data_step"]
        print(f"[resume] from step {start}")

    t_run = time.time()
    for step in range(start, args.steps):
        if args.simulate_failure_at is not None and step == args.simulate_failure_at:
            print(f"[failure-injection] dying at step {step}", flush=True)
            os._exit(42)
        t0 = time.time()
        batch = to_device(data.batch(step), device)
        params, opt, metrics = train_step(params, opt, batch, step)
        sync()
        dt = time.time() - t0
        if dt > args.step_deadline_s:
            print(f"[straggler] step {step} took {dt:.1f}s "
                  f"(deadline {args.step_deadline_s}s) - on a cluster this "
                  f"host would be flagged for replacement", flush=True)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} {dt:.2f}s",
                  flush=True)
        if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
            mgr.save(step + 1, {"params": params, "opt": opt},
                     extra={"data_step": step + 1,
                            "arch": cfg.name, "loss": float(metrics["loss"])})
    print(f"[done] {args.steps - start} steps in {time.time() - t_run:.1f}s")
    return params


if __name__ == "__main__":
    main()
