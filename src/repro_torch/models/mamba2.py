"""Mamba2 / SSD (state-space duality) mixer [arXiv:2405.21060];
counterpart of ``repro/models/mamba2.py``.

Chunked SSD: within each chunk the quadratic "attention form", across
chunks a scan over the chunk states (a Python loop over chunks, where the
reference runs ``lax.scan``).  Decode is the O(1) state update.  Plain
tensor code, as in the reference: only ``in_proj`` and ``out_proj`` go
through ``layers.linear``, hence K1-K3 when the leaf is nested.  In a
sharded step each rank runs its block of the heads (see "sharded" below).

Shapes (one B/C group, as in the Mamba2 reference):
  x:  (b, s, H, P)   dt: (b, s, H)   A: (H,) < 0
  B, C: (b, s, N)    state: (b, H, P, N)
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..distributed import ctx
from ..distributed.ctx import shard_hint
from ..kernels import dispatch
from .layers import col_linear, linear, out_width, rms_norm, row_linear, silu


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
    # diagonal the exponent overflows: it is masked to -inf before exp (0
    # exactly, as the reference's ``where`` after exp gives), so the
    # backward meets no inf (a zero cotangent times exp(inf) is NaN: the
    # reference's gradient at a full-width chunk)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b,nc,Q,Q,H) i,j
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                              torch.full((), -torch.inf, device=x.device)))
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


# ---------------------------------------------------------------------------
# sharded: this rank's block of the heads and conv channels
# ---------------------------------------------------------------------------
# Inside a sharded step whose model axis m > 1 each rank computes H / m of
# the SSM heads (its block of the state) on its block of the conv
# channels, as ``param_pspecs`` / ``cache_pspecs`` lay them out: in_proj
# split on its output columns (a block that cuts across the z | x | B | C
# | dt segments, so the projection is gathered whole), conv and conv_buf on
# their channels (the depthwise conv is channel-local; its output is
# gathered, since B and C are one group every rank needs whole), A_log and
# D over heads, dt_bias and the norms replicated, out_proj on its input
# rows (partial sums).  The gated norm's sum of squares over d_inner is
# summed over model.  Every replicated tensor that feeds this rank's own
# block is entered (``ctx.enter_model``), so its gradient is summed.
def _mine(t, full: int):
    """This rank's block (along the last dim) of ``t``, whose whole width is
    ``full``: ``t`` itself where it already is the block, or off a sharded
    step."""
    r, m = ctx.model_index()
    if m == 1 or t.shape[-1] != full:
        return t
    return ctx.model_slice(t, full // m)


def _in_proj(u, params, cfg, route=None):
    """The whole projection zxbcdt (a column block gathered over model)."""
    w = params["in_proj"]["w"]
    full = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
    if out_width(w) == full:
        return linear(u, w, route=route)
    return ctx.gather_model(col_linear(u, w, None, full, route), -1)


def _pieces(zxbcdt, cfg):
    """(z, raw xBC, dt) of this rank: its heads' z and dt and its block of
    the conv channels (all of each off a sharded step)."""
    din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    r, m = ctx.model_index()
    if m == 1:
        return _split_proj(zxbcdt, din, N, H)
    ze = ctx.enter_model(zxbcdt)
    dl, cl, hl = din // m, (din + 2 * N) // m, H // m
    return (ze[..., r * dl:(r + 1) * dl], ze[..., din + r * cl:din + (r + 1) * cl],
            ze[..., 2 * din + 2 * N + r * hl:2 * din + 2 * N + (r + 1) * hl])


def _conv_split(xBC, cfg):
    """(this rank's x heads, B, C) from its block of the conv output: the
    whole output gathered over model, then cut."""
    din, N = cfg.d_inner, cfg.ssm_state
    r, m = ctx.model_index()
    xe = ctx.enter_model(ctx.gather_model(xBC, -1))
    dl = din // m
    return xe[..., r * dl:(r + 1) * dl], xe[..., din:din + N], xe[..., din + N:]


def _ssm_scalars(dt, params, H: int):
    """softplus(dt + dt_bias) and A = -exp(A_log) on this rank's heads."""
    dt = softplus(dt.float() + _mine(params["dt_bias"], H).float())
    return dt, -torch.exp(_mine(params["A_log"], H).float())


def _norm_sum(ss):
    """The gated norm's sum of squares over this rank's block of d_inner,
    summed over model; its gradient (each rank's part) summed too."""
    return ctx.enter_model(ctx.sum_model(ss))


def _gated_norm(y, scale, full: int, eps: float = 1e-6):
    """``rms_norm`` over the whole d_inner (``full``) of this rank's block
    of it (:func:`_norm_sum`)."""
    if y.shape[-1] == full:
        return rms_norm(y, scale)
    dt = y.dtype
    yf = y.float()
    ss = _norm_sum((yf * yf).sum(dim=-1, keepdim=True))
    yf = yf * torch.rsqrt(ss / full + eps)
    return (yf * _mine(scale, full).float()).to(dt)


def _gate_out(y, x, z, params, shape, dtype, cfg, route=None):
    """y + D x, gated by silu(z), rms-normed, projected out (a row block's
    partial products summed over model)."""
    H, din = cfg.ssm_heads, cfg.d_inner
    y = y + _mine(params["D"], H).float()[..., :, None] * x.float()
    y = y.reshape(shape).to(dtype)
    y = _gated_norm(y * silu(z), params["ssm_norm"]["scale"], din)
    return row_linear(y, params["out_proj"]["w"], din, route=route)


def mamba_block(u: torch.Tensor, params: Dict, cfg,
                init_state=None) -> Tuple[torch.Tensor, Dict]:
    """u: (B,S,d) -> (y (B,S,d), cache {state, conv_buf}); sharded, the
    cache holds this rank's heads and conv channels."""
    Bsz, S, _ = u.shape
    P, H = cfg.ssm_headdim, cfg.ssm_heads
    z, xBC_raw, dt = _pieces(_in_proj(u, params, cfg), cfg)
    conv = params["conv"]
    width = cfg.d_inner + 2 * cfg.ssm_state
    xBC = silu(causal_conv1d(xBC_raw, _mine(conv["w"], width), _mine(conv["b"], width)))
    x, B_mat, C_mat = _conv_split(xBC, cfg)
    x = x.reshape(Bsz, S, -1, P)
    dt, A = _ssm_scalars(dt, params, H)
    x = shard_hint(x, ("batch", None, "heads", None))
    y, state = ssd_chunked(x, dt, A, B_mat, C_mat, cfg.ssm_chunk, init_state=init_state)
    out = _gate_out(y, x, z, params, (Bsz, S, z.shape[-1]), u.dtype, cfg)
    # the decode conv buffer: the last (conv_width - 1) pre-conv inputs
    return out, {"state": state, "conv_buf": xBC_raw[:, -(cfg.ssm_conv_width - 1):]}


def mamba_decode_step(u_t: torch.Tensor, params: Dict, cache: Dict,
                      cfg) -> Tuple[torch.Tensor, Dict]:
    """u_t: (B,1,d) -> (y (B,1,d), new cache {state, conv_buf}); the cache
    given is not written.  ``in_proj`` and ``out_proj`` name the decode
    route (``dispatch.DECODE``)."""
    Bsz = u_t.shape[0]
    P, H = cfg.ssm_headdim, cfg.ssm_heads
    route = dispatch.DECODE
    z, xBC_raw, dt = _pieces(_in_proj(u_t[:, 0, :], params, cfg, route), cfg)
    conv = params["conv"]
    width = cfg.d_inner + 2 * cfg.ssm_state
    xBC, conv_buf = conv_step(xBC_raw, cache["conv_buf"], _mine(conv["w"], width),
                              _mine(conv["b"], width))
    x, B_t, C_t = _conv_split(silu(xBC), cfg)
    x = x.reshape(Bsz, -1, P)
    dt, A = _ssm_scalars(dt, params, H)
    y, state = ssd_decode_step(x, dt, A, B_t, C_t, cache["state"])
    out = _gate_out(y, x, z, params, (Bsz, z.shape[-1]), u_t.dtype, cfg, route=route)
    return out[:, None, :], {"state": state, "conv_buf": conv_buf}
