"""Full lifecycle on the PyTorch/CUDA port: train a small LM with the train
CLI's step (AdamW, warmup-cosine), NestQuant it post-training with
``nest_quantize_tree`` (data-free: no calibration set, per the paper's
SQuant base), and compare FP / full-bit / part-bit perplexity on held-out
batches through ``loss_fn``, which reads the packed words (K1-K3 on the
card).

  PYTHONPATH=src python examples/train_quantize_serve_torch.py [--steps 200] [--device cpu]
"""
import argparse
import time
import warnings

import numpy as np
import torch

from repro_torch import tree
from repro_torch.api import get_config, make_model, nest_quantize_tree, set_tree_rung
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.train import make_train_step, to_device
from repro_torch.optim import adamw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = get_config("qwen2-1.5b").reduced()
    model = make_model(cfg, device=dev)
    params = model.init(0)
    n_params = sum(p.numel() for p in tree.leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.2f}M device={dev}")
    opt = adamw.init_state(params)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 64, 8))
    step = make_train_step(model, peak_lr=5e-3, warmup=20, total=args.steps)

    t0 = time.time()
    for s in range(args.steps):
        params, opt, metrics = step(params, opt, to_device(data.batch(s), dev), s)
        if s % 50 == 0 or s == args.steps - 1:
            print(f"step {s:4d} loss {metrics['loss'].item():.4f}")
    print(f"trained {args.steps} steps in {time.time() - t0:.1f}s")

    # data-free PTQ (Algorithm 1); the shim's Eq. 12 would pick h, here INT(8|4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        nested = nest_quantize_tree(params, n=8, h=4, device=dev)
        alts = {m: nest_quantize_tree(params, n=8, h=4, rounding=m, device=dev)
                for m in ("bitshift", "rtn")}

    batches = [to_device(data.batch(10_000 + i), dev) for i in range(4)]

    @torch.no_grad()
    def ppl(p):
        return float(np.exp(np.mean([model.loss_fn(p, b).item() for b in batches])))

    print(f"FP32      perplexity: {ppl(params):.3f}")
    print(f"full-bit  perplexity: {ppl(set_tree_rung(nested, 1)):.3f}")
    print(f"part-bit  perplexity: {ppl(set_tree_rung(nested, 0)):.3f}")
    for m, alt in alts.items():
        print(f"part-bit ({m:8s}) perplexity: {ppl(set_tree_rung(alt, 0)):.3f}")


if __name__ == "__main__":
    main()
