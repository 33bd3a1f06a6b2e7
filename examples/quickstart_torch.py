"""Quickstart on the PyTorch/CUDA port, through ``repro_torch.api``: build
a model, pick the critical nested combination (Eq. 12), quantize it onto
a ladder, switch rungs by paging delta streams, compare the rungs' losses
through the packed kernels, and serve requests under a memory budget.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

On the card every weight matmul reads the packed words (the CUDA kernels
build at first use); on the CPU the kernels' plain versions run.
"""
import argparse

import numpy as np
import torch

from repro_torch.api import (NestQuantStore, QuantRecipe,
                             Request, ServeEngine, critical_nested_bits,
                             get_config, make_model, quantize, set_tree_rung)
from repro_torch.core.nesting import tree_bytes
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.train import to_device
from repro_torch import tree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # 1. a model (reduced() runs anywhere); random weights from a seed
    cfg = get_config("qwen2-1.5b").reduced()
    model = make_model(cfg, device=dev)
    params = model.init(0)

    # 2. the critical nested combination (paper Eq. 12)
    size_mb = sum(x.numel() * 4 / 1e6 for x in tree.leaves(params))
    h = critical_nested_bits(size_mb, n=8)
    print(f"model {size_mb:.1f} MB fp32 -> INT(8|{h}) nesting")

    # 3. Algorithm 1 over the tree, on a three-rung ladder INT8 > INT6 > INT4
    nested = quantize(params, QuantRecipe(bits=(8, 6, 4)), device=dev)
    b = tree_bytes(nested)
    print(f"packed: {', '.join(f'{k}={v / 1e6:.3f}MB' for k, v in b.items())}")

    # 4. each rung's loss on held-out data, straight from the packed words
    batch = to_device(SyntheticLM(DataConfig(cfg.vocab_size, 64, 4)).batch(10_000), dev)
    with torch.no_grad():
        print(f"dense loss {model.loss_fn(params, batch).item():.4f}")
        for rung in (2, 1, 0):
            loss = model.loss_fn(set_tree_rung(nested, rung), batch).item()
            print(f"rung {rung} (INT{(4, 6, 8)[rung]}) loss {loss:.4f}")

    # 5. switching pages one delta stream per adjacent rung (Table 11)
    store = NestQuantStore(nested, mode="part", device=dev)
    store.to_full()
    for (r_from, r_to, pin, _) in store.ledger.events:
        print(f"rung {r_from} -> {r_to}: paged in {pin / 1e6:.3f}MB")

    # 6. serve under a memory budget: the policy picks the highest rung
    # that fits, and a switch pages exactly one delta stream per rung
    engine = ServeEngine(cfg, store, max_batch=4, max_len=32)
    rng = np.random.default_rng(0)
    need = [store.rung_resident_bytes(r) for r in range(store.num_rungs)]
    for budget in (need[0], need[-1] * 2):
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                        max_new_tokens=4) for i in range(4)]
        engine.generate(reqs, memory_budget_bytes=budget)
        print(f"budget {budget / 1e6:.2f}MB -> rung {store.rung}: "
              f"{[r.out_tokens for r in reqs]}")


if __name__ == "__main__":
    main()
