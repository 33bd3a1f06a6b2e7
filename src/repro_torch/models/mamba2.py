"""Mamba2 / SSD (state-space duality) mixer [arXiv:2405.21060];
counterpart of ``repro/models/mamba2.py``.

Chunked SSD: within each chunk the quadratic "attention form", across
chunks a scan over the chunk states (a Python loop over chunks, where the
reference runs ``lax.scan``).  Decode is the O(1) state update.  Plain
tensor code, as in the reference: only ``in_proj`` and ``out_proj`` go
through ``layers.linear``, hence K1-K3 when the leaf is nested.

Shapes (one B/C group, as in the Mamba2 reference):
  x:  (b, s, H, P)   dt: (b, s, H)   A: (H,) < 0
  B, C: (b, s, N)    state: (b, H, P, N)
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..distributed.ctx import shard_hint
from ..kernels import dispatch
from .layers import linear, rms_norm, silu


# ---------------------------------------------------------------------------
# causal depthwise conv1d (width W) over (b, s, c)
# ---------------------------------------------------------------------------
def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B,S,C); w: (W,C); b: (C,).  The reference's depthwise
    ``conv_general_dilated`` is a cross-correlation over a left pad of W-1
    (``F.conv1d(groups=C)`` with weight ``w.T[:, None, :]``); it is written
    out as W f32 multiply-adds, so no convolution algorithm (nor TF32) picks
    the arithmetic.  Computed in f32, cast back to x's dtype."""
    W, S = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x.float(), (0, 0, W - 1, 0))
    wf = w.float()
    out = xp[:, :S] * wf[0]
    for k in range(1, W):
        out += xp[:, k:k + S] * wf[k]
    return (out + b.float()).to(x.dtype)


def conv_step(x_t: torch.Tensor, buf: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Decode: x_t (B,C), buf (B,W-1,C) holds the previous inputs.
    Returns (y_t (B,C), new buf)."""
    window = torch.cat([buf, x_t[:, None, :].to(buf.dtype)], dim=1)      # (B,W,C)
    y = torch.einsum("bwc,wc->bc", window.float(), w.float()) + b.float()
    return y.to(x_t.dtype), window[:, 1:, :]


# ---------------------------------------------------------------------------
# chunked SSD scan
# ---------------------------------------------------------------------------
def ssd_chunked(x, dt, A, B, C, chunk: int,
                init_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b,s,H,P) f32, final state (b,H,P,N) f32)."""
    b, s, H, P = x.shape
    N = B.shape[-1]
    s_orig = s
    if s % chunk:
        # right-pad with dt = 0 steps: decay exp(0) = 1 and update dt*x = 0,
        # so the outputs of real positions (causal) and the final state
        # are unaffected
        pad = chunk - s % chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
        s = s + pad
    nc, Q = s // chunk, chunk
    xr = x.reshape(b, nc, Q, H, P).float()
    dtr = dt.reshape(b, nc, Q, H).float()
    Br = B.reshape(b, nc, Q, N).float()
    Cr = C.reshape(b, nc, Q, N).float()

    a = dtr * A[None, None, None, :]                         # (b,nc,Q,H), negative
    cum = torch.cumsum(a, dim=2)                             # inclusive cumsum
    # intra-chunk decay L_ij = exp(cum_i - cum_j), j <= i.  Above the
    # diagonal exp overflows to inf: ``where`` selects 0 there (a product
    # with the mask would give inf * 0 = NaN)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b,nc,Q,Q,H) i,j
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.where(mask[None, None, :, :, None], torch.exp(diff), torch.zeros((), device=x.device))
    scores = torch.einsum("bcin,bcjn->bcij", Cr, Br)         # (b,nc,Q,Q)
    G = scores[..., None] * L * dtr[:, :, None, :, :]        # (b,nc,Q,Q,H)
    del diff, L
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", G, xr)
    del G

    # chunk summary states: S_c = sum_j exp(cum_last - cum_j) dt_j x_j B_j
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)           # (b,nc,Q,H)
    states = torch.einsum("bcjhp,bcjn->bchpn", xr * (decay_out * dtr)[..., None], Br)
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (b,nc,H)

    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    starts = []
    for c in range(nc):                                      # state at each chunk start
        starts.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_starts = torch.stack(starts, dim=1)                    # (b,nc,H,P,N)

    # inter-chunk contribution: y_off_i = exp(cum_i) * C_i . H_chunkstart
    y_off = torch.einsum("bcin,bchpn->bcihp", Cr, h_starts) * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(b, s, H, P)[:, :s_orig]
    return y, h


def ssd_decode_step(x_t, dt_t, A, B_t, C_t, state):
    """x_t: (b,H,P), dt_t: (b,H), B_t/C_t: (b,N), state: (b,H,P,N).
    Returns (y (b,H,P) f32, new state f32)."""
    dtf = dt_t.float()
    dA = torch.exp(dtf * A[None, :])                         # (b,H)
    upd = (dtf[:, :, None] * x_t.float())[..., None] * B_t.float()[:, None, None, :]
    new_state = state.float() * dA[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C_t.float())
    return y, new_state


# ---------------------------------------------------------------------------
# full Mamba2 block
# ---------------------------------------------------------------------------
def softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's softplus, log(1 + e^x) = log1p(exp(-|x|)) + max(x, 0), at every
    x (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_proj(zxbcdt, din: int, N: int, H: int):
    z = zxbcdt[..., :din]
    xBC = zxbcdt[..., din:2 * din + 2 * N]
    dt = zxbcdt[..., 2 * din + 2 * N:]
    assert dt.shape[-1] == H, (dt.shape, H)
    return z, xBC, dt


def _gate_out(y, x, z, params, shape, dtype, route=None):
    """y + D x, gated by silu(z), rms-normed, projected out."""
    y = y + params["D"].float()[..., :, None] * x.float()
    y = y.reshape(shape).to(dtype)
    y = rms_norm(y * silu(z), params["ssm_norm"]["scale"])
    return linear(y, params["out_proj"]["w"], route=route)


def mamba_block(u: torch.Tensor, params: Dict, cfg,
                init_state=None) -> Tuple[torch.Tensor, Dict]:
    """u: (B,S,d) -> (y (B,S,d), cache {state, conv_buf})."""
    Bsz, S, _ = u.shape
    din, N, P, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_heads
    zxbcdt = linear(u, params["in_proj"]["w"])
    z, xBC, dt = _split_proj(zxbcdt, din, N, H)
    xBC = silu(causal_conv1d(xBC, params["conv"]["w"], params["conv"]["b"]))
    x = xBC[..., :din].reshape(Bsz, S, H, P)
    B_mat = xBC[..., din:din + N]
    C_mat = xBC[..., din + N:]
    dt = softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    x = shard_hint(x, ("batch", None, "heads", None))
    y, state = ssd_chunked(x, dt, A, B_mat, C_mat, cfg.ssm_chunk, init_state=init_state)
    out = _gate_out(y, x, z, params, (Bsz, S, din), u.dtype)
    return out, {"state": state, "conv_buf": xBC_raw_tail(u, zxbcdt, din, N, cfg)}


def xBC_raw_tail(u, zxbcdt, din, N, cfg):
    """The last (conv_width - 1) pre-conv xBC inputs (the decode conv
    buffer)."""
    return zxbcdt[:, -(cfg.ssm_conv_width - 1):, din:2 * din + 2 * N]


def mamba_decode_step(u_t: torch.Tensor, params: Dict, cache: Dict,
                      cfg) -> Tuple[torch.Tensor, Dict]:
    """u_t: (B,1,d) -> (y (B,1,d), new cache {state, conv_buf}); the cache
    given is not written.  ``in_proj`` and ``out_proj`` name the decode
    route (``dispatch.DECODE``)."""
    Bsz = u_t.shape[0]
    din, N, P, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_heads
    route = dispatch.DECODE
    zxbcdt = linear(u_t[:, 0, :], params["in_proj"]["w"], route=route)
    z, xBC_raw, dt = _split_proj(zxbcdt, din, N, H)
    xBC, conv_buf = conv_step(xBC_raw, cache["conv_buf"], params["conv"]["w"],
                              params["conv"]["b"])
    xBC = silu(xBC)
    x = xBC[..., :din].reshape(Bsz, H, P)
    B_t = xBC[..., din:din + N]
    C_t = xBC[..., din + N:]
    dt = softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    y, state = ssd_decode_step(x, dt, A, B_t, C_t, cache["state"])
    out = _gate_out(y, x, z, params, (Bsz, din), u_t.dtype, route=route)
    return out[:, None, :], {"state": state, "conv_buf": conv_buf}
