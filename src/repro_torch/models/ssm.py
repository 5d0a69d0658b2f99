"""Mamba2 (SSD) block — the chunked training scan and the O(1) decode step
(twin of ``repro.models.ssm``).

The selective state space recurrence a head (state n, head dim p):

    h_t = exp(A * dt_t) * h_{t-1} + dt_t * B_t (x)  (outer product p x n)
    y_t = C_t . h_t + D * x_t

Training takes the SSD chunked algorithm: within a chunk the contribution
is an attention-like (c x c) quadratic form with a decay mask; across
chunks a loop carries the (B, H, p, n) state (the reference's
``lax.scan``). Peak memory is one chunk's (B, c, c, H) decay tensor.

Casts stand where the reference has them: ``dt`` and the log decay are
f32; the dt-weighted input, the state ``h`` and the einsum operands are in
the model's dtype. The reference's work here is plain ``jnp`` (no Pallas
kernel), so this is plain PyTorch too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

Params = dict[str, torch.Tensor]


def chunk_of(s: int, chunk: int) -> int:
    """The chunk length of an S-token sequence, ``min(chunk, S)``; raises
    ``ValueError`` unless it divides S (the reference's chunk scans assert
    it; the xLSTM's mLSTM scan takes it too)."""
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"a sequence of {s} tokens does not divide into chunks of {c} "
                         f"(ssm_chunk {chunk}): give a length that is a multiple of it")
    return c


def _split_proj(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """in_proj -> z (gate), xin, B, C, dt; dt (B, S, nh) in f32."""
    di, st = cfg.d_inner, cfg.ssm_state
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xin = zxbcdt[..., di:2 * di]
    bmat = zxbcdt[..., 2 * di:2 * di + st]
    cmat = zxbcdt[..., 2 * di + st:2 * di + 2 * st]
    dt = F.softplus(zxbcdt[..., 2 * di + 2 * st:].float() + p["dt_bias"].float())
    return z, xin, bmat, cmat, dt


def _conv_train(p: Params, u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel 4, over (B, S, C)."""
    kw = p["conv_w"]  # (4, C)
    s = u.shape[1]
    pad = F.pad(u, (0, 0, kw.shape[0] - 1, 0))
    out = sum(pad[:, i:i + s, :] * kw[i] for i in range(kw.shape[0]))
    return F.silu(out + p["conv_b"])


def ssd_scan(cc: torch.Tensor, bc: torch.Tensor, xc: torch.Tensor, la: torch.Tensor,
             h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD over chunks. cc, bc (B, nc, c, st), xc (B, nc, c, nh, hp) in
    the model's dtype; la (B, nc, c, nh) f32, the log decay of each
    position; h (B, nh, hp, st) the state before the first chunk. Returns
    (y (B, nc, c, nh, hp), the state after the last chunk).

    The reference's scan body, regrouped: what needs no state (C.B, the
    chunk sums of B (x) xdt, each chunk's total decay) is taken for every
    chunk at once, no larger than the input; a loop carries the state
    across chunks (cheap (B, nh, hp, st) updates); a second loop takes the
    within-chunk quadratic form a chunk at a time, so peak memory stays one
    chunk's (B, nh, c, c) decay tensor. Each einsum of the reference is the
    same contraction here, with its operands cast as there. The decay is
    exp of the log-decay differences with -inf above the diagonal: the
    value of the reference's ``where(tri, exp(ldiff), 0)``, and a gradient
    that stays finite where exp(ldiff) above the diagonal would overflow (a
    long chunk of large dt)."""
    cum = torch.cumsum(la, dim=2)  # each chunk's running log decay
    c = cum.shape[2]
    dt = cc.dtype
    gmat = cc @ bc.transpose(-1, -2)  # (B, nc, c, c): C_i . B_j
    # h' = e^{cum_last} h + sum_j e^{cum_last - cum_j} B_j (x) xdt_j
    w = torch.exp(cum[:, :, -1:, :] - cum).to(dt)  # (B, nc, c, nh)
    s_chunk = torch.einsum("bncs,bnch,bnchp->bnhps", bc, w, xc)
    a_tot = torch.exp(cum[:, :, -1, :]).to(h.dtype)[..., None, None]  # (B, nc, nh, 1, 1)
    h_prev = []
    for i in range(cum.shape[1]):
        h_prev.append(h)
        h = h * a_tot[:, i] + s_chunk[:, i]
    # Across chunks: y_inter[i] = e^{cum_i} * C_i . h_prev
    y_inter = torch.einsum("bncs,bnhps,bnch->bnchp", cc, torch.stack(h_prev, dim=1),
                           torch.exp(cum).to(dt))
    # Within a chunk: y_intra[i] = sum_{j<=i} (C_i.B_j) e^{cum_i - cum_j} xdt_j
    above = ~torch.tril(torch.ones((c, c), dtype=torch.bool, device=cum.device))
    cum_t = cum.transpose(2, 3)  # (B, nc, nh, c)
    x_t = xc.permute(0, 1, 3, 2, 4)  # (B, nc, nh, c, hp)
    y_intra = []
    for i in range(cum.shape[1]):
        ldiff = cum_t[:, i, :, :, None] - cum_t[:, i, :, None, :]  # (B, nh, c, c)
        decay = torch.exp(ldiff.masked_fill(above, float("-inf")))
        m = gmat[:, i, None] * decay.to(dt)  # (B, nh, c, c)
        y_intra.append(m.to(x_t.dtype) @ x_t[:, i])  # (B, nh, c, hp)
    return torch.stack(y_intra, dim=1).transpose(2, 3) + y_inter, h


def mamba2_train(p: Params, x: torch.Tensor, cfg: ModelConfig, return_state: bool = False):
    """Full-sequence SSD. x: (B, S, D) -> (B, S, D).

    With ``return_state`` also returns (ssm_state (B, nh, hp, st),
    conv_state (B, 3, conv channels)) for decoding. S must divide into
    chunks of ``min(cfg.ssm_chunk, S)``."""
    b, s, _ = x.shape
    nh, hp, st = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    c = chunk_of(s, cfg.ssm_chunk)
    nc = s // c

    z, xin, bmat, cmat, dt = _split_proj(p, x, cfg)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_state = conv_in[:, -3:, :]
    conv_out = _conv_train(p, conv_in)
    xin = conv_out[..., :cfg.d_inner]
    bmat = conv_out[..., cfg.d_inner:cfg.d_inner + st]
    cmat = conv_out[..., cfg.d_inner + st:]

    a = -torch.exp(p["a_log"].float())  # (nh,)
    la = dt * a  # log decay (B, S, nh)
    xh = xin.reshape(b, s, nh, hp)
    xdt = xh * dt[..., None].to(xh.dtype)  # dt-weighted input

    h0 = torch.zeros((b, nh, hp, st), dtype=xh.dtype, device=x.device)
    ys, h_final = ssd_scan(cmat.reshape(b, nc, c, st), bmat.reshape(b, nc, c, st),
                           xdt.reshape(b, nc, c, nh, hp), la.reshape(b, nc, c, nh), h0)
    y = ys.reshape(b, s, nh, hp)
    y = y + xh * p["d_skip"][None, None, :, None]
    y = _gated_norm(y.reshape(b, s, cfg.d_inner), z, p["norm"])
    out = y @ p["out_proj"]
    if return_state:
        return out, h_final, conv_state
    return out


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    y = y * F.silu(z)
    var = y.float().square().mean(dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + 1e-6).to(y.dtype)) * scale


def mamba2_decode(
    p: Params,
    x: torch.Tensor,  # (B, 1, D)
    ssm_state: torch.Tensor,  # (B, nh, hp, st)
    conv_state: torch.Tensor,  # (B, 3, conv channels)
    cfg: ModelConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token; returns (y (B, 1, D), ssm_state', conv_state'), the
    states as new tensors (the caller writes them into its cache)."""
    b = x.shape[0]
    nh, hp, st = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, xin, bmat, cmat, dt = _split_proj(p, x, cfg)
    u = torch.cat([xin, bmat, cmat], dim=-1)[:, 0]  # (B, C)
    full = torch.cat([conv_state, u[:, None, :]], dim=1)  # (B, 4, C)
    conv = F.silu(torch.einsum("bkc,kc->bc", full, p["conv_w"]) + p["conv_b"])
    conv_state = full[:, 1:]
    xin = conv[:, :cfg.d_inner]
    bmat = conv[:, cfg.d_inner:cfg.d_inner + st]
    cmat = conv[:, cfg.d_inner + st:]

    a = -torch.exp(p["a_log"].float())
    dt0 = dt[:, 0]  # (B, nh)
    decay = torch.exp(dt0 * a).to(x.dtype)  # (B, nh)
    xh = xin.reshape(b, nh, hp) * dt0[..., None].to(x.dtype)
    upd = torch.einsum("bhp,bs->bhps", xh, bmat)
    ssm_state = ssm_state * decay[..., None, None] + upd
    y = torch.einsum("bhps,bs->bhp", ssm_state, cmat)
    y = y + xin.reshape(b, nh, hp) * p["d_skip"][None, :, None]
    y = _gated_norm(y.reshape(b, 1, cfg.d_inner), z, p["norm"])
    return y @ p["out_proj"], ssm_state, conv_state
