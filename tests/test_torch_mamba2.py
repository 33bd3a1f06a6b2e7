"""Port parity of ``models/mamba2.py`` on the CPU in f32: each function
against the JAX package's on the same numpy inputs from a seed, within
1e-5 absolute / 1e-4 relative (``assert_allclose(rtol=1e-4, atol=1e-5)``).
``ssd_chunked``'s outputs are sums over whole chunks, summed in another
order by each package, so an element near zero carries the rounding of
its large terms: it is held to 1e-5 + 1e-4 of max |y| (the model tests'
measure) and, at S = 2048, to a float64 recurrence, which both packages
are within 1e-5 of max |y| of.

* ``causal_conv1d``, ``conv_step`` (one step, and chained from a zero
  buffer against ``causal_conv1d``), ``softplus`` (JAX's, at every x);
* ``ssd_chunked`` at S = 2048 over chunks of 256, at a ragged S (the
  dt = 0 right pad), with an initial state, and with decays whose
  exponent overflows above the chunk diagonal (no NaN, forward and
  backward);
* ``ssd_decode_step``, ``_split_proj``, and ``mamba_block`` (output and
  returned state and conv buffer) and ``mamba_decode_step`` on one layer
  of the reduced mamba2-780m's parameters carried over through numpy."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import mamba2
from torch_parity import j2n, jax_tree_to_torch, reduced_dense, t2n

jm = importlib.import_module("repro.models.mamba2")

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    np.testing.assert_allclose(t2n(got), j2n(want), rtol=RTOL, atol=ATOL)


def _close_to_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= ATOL + RTOL * np.abs(want).max()


def _recurrence(x, dt, A, Bm, Cm, h0=None):
    """The SSD scan one position at a time in float64: (y, final state)."""
    b, s, H, P = x.shape
    h = np.zeros((b, H, P, Bm.shape[-1])) if h0 is None else h0.astype(np.float64)
    ys = np.zeros((b, s, H, P))
    for t in range(s):
        upd = (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None, :]
        h = h * np.exp(dt[:, t] * A)[:, :, None, None] + upd
        ys[:, t] = np.einsum("bhpn,bn->bhp", h, Cm[:, t].astype(np.float64))
    return ys, h


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def test_causal_conv1d_and_conv_step_match_reference():
    rng = np.random.default_rng(0)
    B, S, C, W = 2, 11, 24, 4
    (jx, jw, jb), (x, w, b) = _both(_normal(rng, B, S, C), _normal(rng, W, C, scale=0.5),
                                    _normal(rng, C))
    full = mamba2.causal_conv1d(x, w, b)
    _close(full, jm.causal_conv1d(jx, jw, jb))
    (jbuf, jxt), (buf, xt) = _both(_normal(rng, B, W - 1, C), _normal(rng, B, C))
    y, nbuf = mamba2.conv_step(xt, buf, w, b)
    jy, jnbuf = jm.conv_step(jxt, jbuf, jw, jb)
    _close(y, jy)
    assert torch.equal(nbuf, torch.from_numpy(j2n(jnbuf)))
    # chained from a zero buffer, the steps are the causal conv
    buf = torch.zeros(B, W - 1, C)
    steps = []
    for t in range(S):
        yt, buf = mamba2.conv_step(x[:, t], buf, w, b)
        steps.append(yt)
    np.testing.assert_allclose(t2n(torch.stack(steps, 1)), t2n(full), rtol=RTOL, atol=ATOL)
    assert torch.equal(buf, x[:, -(W - 1):])


def test_softplus_is_jaxs_everywhere():
    x = np.concatenate([np.linspace(-60, 60, 241), [0.0, 19.9, 20.1, 88.0, -88.0]])
    x = x.astype(np.float32)
    got = mamba2.softplus(torch.from_numpy(x))
    # XLA:CPU flushes the subnormal softplus(-88) = 6.05e-39 to zero
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-37)


def _ssd_inputs(seed, b, s, H, P, N, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    x = _normal(rng, b, s, H, P)
    dt = (np.abs(_normal(rng, b, s, H)) * dt_scale).astype(np.float32)
    A = -np.exp(_normal(rng, H, scale=0.5)).astype(np.float32)
    Bm, Cm = _normal(rng, b, s, N), _normal(rng, b, s, N)
    h0 = _normal(rng, b, H, P, N)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("s,chunk,init", [(2048, 256, False), (37, 8, False), (37, 8, True),
                                          (40, 8, True)],
                         ids=["2048-chunk256", "ragged", "ragged-init", "whole-init"])
def test_ssd_chunked_matches_reference(s, chunk, init):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(s, 2, s, 3, 4, 8)
    (jx, jdt, jA, jB, jC, jh0), ts = _both(x, dt, A, Bm, Cm, h0)
    y, state = mamba2.ssd_chunked(*ts[:5], chunk, init_state=ts[5] if init else None)
    jy, jstate = jm.ssd_chunked(jx, jdt, jA, jB, jC, chunk, init_state=jh0 if init else None)
    assert y.shape == (2, s, 3, 4) and state.shape == (2, 3, 4, 8)
    _close_to_max(t2n(y), j2n(jy))
    _close_to_max(t2n(state), j2n(jstate))
    if s == 2048:
        ys, hs = _recurrence(x, dt.astype(np.float64), A.astype(np.float64), Bm, Cm)
        for a in (t2n(y), j2n(jy)):
            assert np.abs(a - ys).max() <= 1e-5 * np.abs(ys).max()
        _close_to_max(t2n(state), hs)


def test_ssd_chunked_overflowing_decay_above_the_diagonal_gives_no_nan():
    """dt * A sums to about -400 over a chunk: exp(cum_i - cum_j) is inf
    for j > i, where the mask must select 0, not multiply by it."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(5, 1, 64, 2, 4, 8, dt_scale=8.0)
    cum = np.cumsum(dt[0, :32] * A, axis=0)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(cum[0] - cum[-1])).any()
    (jx, jdt, jA, jB, jC), ts = _both(x, dt, A, Bm, Cm)
    y, state = mamba2.ssd_chunked(*ts, 32)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    jy, jstate = jm.ssd_chunked(jx, jdt, jA, jB, jC, 32)
    _close_to_max(t2n(y), j2n(jy))
    _close_to_max(t2n(state), j2n(jstate))


def test_ssd_chunked_gradient_is_finite_where_the_decay_overflows():
    """The same overflowing decays, differentiated (a full-width model's
    chunk of 256 at dt ~ 0.7 overflows too): the exponent is masked before
    exp, so no inf meets a zero cotangent (which gives NaN); the gradients
    equal the step-by-step recurrence's in float64 within 1e-4 of their
    max."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(5, 1, 64, 2, 4, 8, dt_scale=8.0)
    w = _normal(np.random.default_rng(9), *x.shape)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, Bm, Cm)]
    y, _ = mamba2.ssd_chunked(leaves[0], leaves[1], torch.from_numpy(A), leaves[2],
                              leaves[3], 32)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), leaves)
    ref = [torch.from_numpy(a).double().requires_grad_(True) for a in (x, dt, Bm, Cm)]
    tx, tdt, tB, tC = ref
    h = torch.zeros(x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(x.shape[1]):
        upd = (tdt[:, t, :, None] * tx[:, t])[..., None] * tB[:, t, None, None, :]
        h = h * torch.exp(tdt[:, t] * torch.from_numpy(A).double())[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, tC[:, t]))
    want = torch.autograd.grad((torch.stack(ys, 1) * torch.from_numpy(w).double()).sum(), ref)
    for g, wg in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g.double() - wg).abs().max()) <= 1e-4 * float(wg.abs().max())


def test_ssd_decode_step_continues_the_chunked_scan():
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(3, 2, 1, 3, 4, 8)
    (jx, jdt, jA, jB, jC, jh0), (tx, tdt, tA, tB, tC, th0) = _both(
        x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], h0)
    y, state = mamba2.ssd_decode_step(tx, tdt, tA, tB, tC, th0)
    jy, jstate = jm.ssd_decode_step(jx, jdt, jA, jB, jC, jh0)
    _close(y, jy)
    _close(state, jstate)
    # one step equals a one-token chunked scan from the same state
    yc, sc = mamba2.ssd_chunked(tx[:, None], tdt[:, None], tA, tB[:, None], tC[:, None], 8,
                                init_state=th0)
    np.testing.assert_allclose(t2n(yc[:, 0]), t2n(y), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t2n(sc), t2n(state), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def layer():
    """Layer 1 of the reduced mamba2-780m (JAX init, ``PRNGKey(0)``): the
    JAX layer dict, the port's, and the config."""
    jcfg, dense = reduced_dense("mamba2-780m")
    jlp = jax.tree_util.tree_map(lambda a: a[1], dense["blocks"])
    # give the SSM scalars values other than their init (A = -1, D = 1)
    rng = np.random.default_rng(9)
    H = jcfg.ssm_heads
    for name in ("dt_bias", "A_log", "D"):
        jlp[name] = jnp.asarray(_normal(rng, H, scale=0.5))
    jlp["conv"]["b"] = jnp.asarray(_normal(rng, *jlp["conv"]["b"].shape, scale=0.1))
    return jlp, jax_tree_to_torch(jlp), get_config("mamba2-780m").reduced(), jcfg


def test_split_proj_matches_reference(layer):
    _, _, cfg, jcfg = layer
    z = np.random.default_rng(1).normal(size=(2, 3, 2 * cfg.d_inner + 2 * cfg.ssm_state
                                              + cfg.ssm_heads)).astype(np.float32)
    got = mamba2._split_proj(torch.from_numpy(z), cfg.d_inner, cfg.ssm_state, cfg.ssm_heads)
    want = jm._split_proj(jnp.asarray(z), jcfg.d_inner, jcfg.ssm_state, jcfg.ssm_heads)
    for g, w in zip(got, want):
        assert torch.equal(g, torch.from_numpy(j2n(w)))


@pytest.mark.parametrize("S", [16, 13])
def test_mamba_block_and_its_cache_match_reference(layer, S):
    jlp, lp, cfg, jcfg = layer
    u = np.random.default_rng(S).normal(size=(2, S, cfg.d_model)).astype(np.float32)
    out, cache = mamba2.mamba_block(torch.from_numpy(u), lp, cfg)
    jout, jcache = jm.mamba_block(jnp.asarray(u), jlp, jcfg)
    _close(out, jout)
    _close(cache["state"], jcache["state"])
    _close(cache["conv_buf"], jcache["conv_buf"])
    assert cache["conv_buf"].shape == (2, cfg.ssm_conv_width - 1,
                                       cfg.d_inner + 2 * cfg.ssm_state)
    assert cache["state"].dtype == torch.float32


def test_mamba_decode_step_matches_reference_and_the_block(layer):
    jlp, lp, cfg, jcfg = layer
    S = 12
    u = np.random.default_rng(4).normal(size=(2, S + 1, cfg.d_model)).astype(np.float32)
    full, _ = mamba2.mamba_block(torch.from_numpy(u), lp, cfg)
    _, cache = mamba2.mamba_block(torch.from_numpy(u[:, :S]), lp, cfg)
    _, jcache = jm.mamba_block(jnp.asarray(u[:, :S]), jlp, jcfg)
    before = {k: v.clone() for k, v in cache.items()}
    y, new = mamba2.mamba_decode_step(torch.from_numpy(u[:, S:]), lp, cache, cfg)
    jy, jnew = jm.mamba_decode_step(jnp.asarray(u[:, S:]), jlp, jcache, jcfg)
    assert all(torch.equal(before[k], cache[k]) for k in cache)   # the input is not written
    _close(y, jy)
    _close(new["state"], jnew["state"])
    _close(new["conv_buf"], jnew["conv_buf"])
    np.testing.assert_allclose(t2n(y[:, 0]), t2n(full[:, S]), rtol=RTOL, atol=ATOL)
