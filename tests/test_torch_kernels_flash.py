"""Port parity of K5 (causal GQA flash attention, forward): the port's plain
versions against the JAX kernel in interpret mode at the shapes of
tests/test_kernels.py, a ragged S against the JAX op (which takes its
reference route there), and the long-prefill route of ``attn_seq``."""
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_op
from repro.models.attention import blockwise_attention as jax_blockwise
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models.attention import blockwise_attention
from torch_parity import flash_inputs, j2n, jax_flash, t2n

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DIMS = [(1, 512, 4, 2, 64), (2, 256, 8, 2, 32), (1, 256, 4, 4, 128)]


@pytest.mark.parametrize("dims", DIMS)
def test_plain_flash_matches_jax_kernel_f32(dims):
    """The op's plain route, its blockwise version at a block that tiles
    S, and the oracle (causal full attention) all within 1e-4 of the JAX
    kernel."""
    want = jax_flash(dims, "float32", dims[1], 128)
    (_, q), (_, k), (_, v) = flash_inputs(dims, "float32", dims[1])
    for got in (ops.flash_attention(q, k, v), blockwise_attention(q, k, v, True, 128),
                ref.attention_ref(q, k, v)):
        np.testing.assert_allclose(t2n(got), want, rtol=TOL["float32"], atol=TOL["float32"])


def test_plain_flash_matches_jax_kernel_bf16():
    dims = DIMS[1]
    want = jax_flash(dims, "bfloat16", dims[1], 128)
    (_, q), (_, k), (_, v) = flash_inputs(dims, "bfloat16", dims[1])
    got = ops.flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(t2n(got), want, rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("S", [1100, 77])
def test_ragged_s_matches_jax_op_reference_route(S):
    """An S that is no multiple of the block: JAX's op takes its reference
    route (causal full attention), and so does the JAX model's blockwise
    path; the port's op (its plain route) and oracle agree with both."""
    dims = (1, S, 4, 2, 16)
    (qj, q), (kj, k), (vj, v) = flash_inputs(dims, "float32", 5)
    want = j2n(jax_flash_op(qj, kj, vj, interpret=True))
    np.testing.assert_allclose(want, j2n(jax_blockwise(qj, kj, vj, True, 512)), rtol=1e-6,
                               atol=1e-6)
    for got in (ops.flash_attention(q, k, v), ref.attention_ref(q, k, v)):
        np.testing.assert_allclose(t2n(got), want, rtol=TOL["float32"], atol=TOL["float32"])


def test_attn_seq_long_prompt_takes_the_plain_blockwise_route_on_cpu():
    """On a CPU tensor a prompt over 1024 tokens runs the plain blockwise
    version and counts it as a plain run of K5; K5 itself never launches."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import attn_seq, init_params, layer_params

    cfg = get_config("qwen2-1.5b").reduced()
    lp = layer_params(init_params(cfg, seed=0, device="cpu")["blocks"], 0)
    x = torch.randn(1, 1536, cfg.d_model, generator=torch.Generator().manual_seed(0))
    before = (ops.COUNTER.launches, ops.COUNTER.plain_launches)
    out, (k, v) = attn_seq(x, lp, cfg)
    assert (ops.COUNTER.launches, ops.COUNTER.plain_launches) == (before[0], before[1] + 1)
    assert out.shape == x.shape and k.shape == (1, 1536, cfg.num_kv_heads, cfg.head_dim)
    with dispatch.reference_pass():
        again, _ = attn_seq(x, lp, cfg)
    assert torch.equal(out, again)
    assert ops.COUNTER.plain_launches == before[1] + 2

