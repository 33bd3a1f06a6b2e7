"""Port parity of training: the differentiable blockwise attention against
``jax.vjp`` of the reference's custom VJP; ``loss_fn`` and its gradient in
every leaf for the reduced dense, MoE, SSM and hybrid configs against
``jax.value_and_grad`` of the reference's, remat on and off; the train
CLI's crash and bitwise resume; a loss that falls over 30 steps; the
train-quantize-score example.

Tolerances (f32): attention outputs and gradients within 1e-5 of each
tensor's max |value| (bf16: 2e-2); a loss within 1e-5 relative, every
gradient leaf within 1e-4 of that leaf's max |g| (products and sums in
another order, through 2-4 layers and a 1536-token attention)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import make_model as jax_make_model
from repro.models.attention import blockwise_attention as jax_blockwise
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.train import make_train_step, to_device
from repro_torch.models import make_model
from repro_torch.models.attention import blockwise_attention
from repro_torch.optim import adamw
from torch_parity import j2n, jax_tree_to_torch, t2n

ROOT = Path(__file__).resolve().parents[1]
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _rel(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,kv_block", [(64, 16), (72, 16)])
def test_blockwise_attention_grads_match_the_reference_vjp(S, kv_block, dtype):
    """S = 64: four KV blocks through the blockwise backward; S = 72: no
    multiple of the block, where the reference differentiates direct
    attention."""
    rng = np.random.default_rng(S)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    shapes = [(2, S, 4, 16), (2, S, 2, 16), (2, S, 2, 16), (2, S, 4, 16)]
    jq, jk, jv, jdo = (jnp.asarray(rng.normal(size=s).astype(np.float32), jdt) for s in shapes)
    o_ref, vjp = jax.vjp(lambda q, k, v: jax_blockwise(q, k, v, True, kv_block), jq, jk, jv)
    want = vjp(jdo)
    leaves = [torch.from_numpy(j2n(x)).to(getattr(torch, dtype)).requires_grad_(True)
              for x in (jq, jk, jv)]
    o = blockwise_attention(*leaves, True, kv_block)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(j2n(jdo)).to(o.dtype))
    assert _rel(t2n(o), j2n(o_ref)) <= ATTN_TOL[dtype]
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == o.dtype and g.shape == w.shape, name
        assert _rel(t2n(g), j2n(w)) <= ATTN_TOL[dtype], name


FAMILIES = {"qwen2-1.5b": (1, 1536), "dbrx-132b": (2, 32), "mamba2-780m": (2, 32),
            "zamba2-2.7b": (2, 32)}


@pytest.fixture(scope="module")
def reference_grads():
    """Per family: (dense params, batch, JAX loss, JAX gradients), the JAX
    package's reduced config (remat on, its default), its init and
    ``value_and_grad`` under ``jax.jit`` (both packages take the same
    parameters, whatever XLA's rounding of the init)."""
    from repro.configs import get_config as jax_get_config

    out = {}
    for name, (B, S) in FAMILIES.items():
        cfg = jax_get_config(name).reduced()
        dense = jax.jit(jax_make_model(cfg).init)(jax.random.PRNGKey(0))
        batch = SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=5)).batch(0)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.jit(jax.value_and_grad(jax_make_model(cfg).loss_fn))(dense, jbatch)
        out[name] = (dense, batch, float(loss), grads)
    return out


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_loss_and_grads_match_the_reference(reference_grads, name, remat):
    """dense qwen2 at 1 x 1536 tokens (the blockwise attention over three
    KV blocks); dbrx (capacity-dropped routing and the aux loss), mamba2
    and zamba2 at 2 x 32."""
    import dataclasses

    dense, batch, want_loss, want_grads = reference_grads[name]
    cfg = dataclasses.replace(get_config(name).reduced(), remat=remat)
    model = make_model(cfg, device="cpu")
    params = jax_tree_to_torch(dense)
    flat = tree.flatten_with_path(params)
    leaves = [p.detach().requires_grad_(True) for _, p in flat]
    loss = model.loss_fn(tree.unflatten(params, leaves), to_device(batch, "cpu"))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - want_loss) <= LOSS_TOL * abs(want_loss)
    jflat = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    assert [k for k, _ in flat] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (key, _), g, (_, w) in zip(flat, grads, jflat):
        assert np.isfinite(t2n(g)).all(), key
        assert _rel(t2n(g), j2n(w)) <= GRAD_TOL, key


def test_loss_falls_over_30_steps():
    """The reduced dense model trained 30 steps with the CLI's train step
    (as tests/test_system.py trains the JAX package's)."""
    cfg = get_config("qwen2-1.5b").reduced()
    model = make_model(cfg, device="cpu")
    params = model.init(0)
    opt = adamw.init_state(params)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 8))
    step = make_train_step(model, peak_lr=5e-3, warmup=0, total=10 ** 9)
    losses = []
    for s in range(30):
        params, opt, metrics = step(params, opt, to_device(data.batch(s), "cpu"), s)
        losses.append(metrics["loss"].item())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


CLI_ARGS = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "6", "--batch", "2", "--seq", "64",
            "--ckpt-every", "4", "--device", "cpu"]


def _train_in_process(ckpt, capsys):
    """The train CLI's ``main`` in this process -> its stdout; the
    deterministic mode it turns on is turned off again."""
    from repro_torch.launch import train

    try:
        train.main([*CLI_ARGS, "--ckpt-dir", str(ckpt)])
    finally:
        torch.use_deterministic_algorithms(False)
    return capsys.readouterr().out


def test_train_cli_crash_and_bitwise_resume(tmp_path, capsys):
    """Killed before step 5 (exit 42, a subprocess: the CLI hard-exits),
    then resumed from its step-4 checkpoint; beside it the run that did
    not stop.  The two step-6 checkpoints are equal leaf for leaf, bit for
    bit."""
    crashed = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI_ARGS, "--ckpt-dir",
         str(tmp_path / "b"), "--simulate-failure-at", "5"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out_a = _train_in_process(tmp_path / "a", capsys)
    out_b, _ = crashed.communicate(timeout=300)
    assert crashed.returncode == 42, out_b
    assert "[failure-injection] dying at step 5" in out_b
    assert sorted(os.listdir(tmp_path / "b")) == ["step_0000000004"]
    out_c = _train_in_process(tmp_path / "b", capsys)
    assert "[resume] from step 4" in out_c, out_c
    # step 5's log line, but for its wall time
    assert out_a.splitlines()[-2].rsplit(" ", 1)[0] == out_c.splitlines()[-2].rsplit(" ", 1)[0]
    a = np.load(tmp_path / "a" / "step_0000000006" / "arrays.npz")
    b = np.load(tmp_path / "b" / "step_0000000006" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 40
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes(), k


def test_train_quantize_score_example_runs_on_the_cpu(capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_quantize_serve_torch", ROOT / "examples" / "train_quantize_serve_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--steps", "5", "--device", "cpu"])
    lines = capsys.readouterr().out
    for what in ("FP32      perplexity", "full-bit  perplexity", "part-bit  perplexity"):
        assert what in lines, lines
