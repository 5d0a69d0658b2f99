"""xLSTM blocks: the chunkwise-parallel mLSTM and the sequential sLSTM (twin
of ``repro.models.xlstm``).

mLSTM: a matrix memory C (hd x hd) a head, with an exponential input gate
and a sigmoid forget gate, trained in the chunkwise-parallel form
(log-space gate algebra and a running-max stabiliser m), so the backward
keeps one chunk's quadratic form a chunk instead of S matrix states. A
Python loop carries (C, n, m) across the chunks (the reference's
``lax.scan``).

sLSTM: a scalar memory with a block-diagonal (per-head) recurrent matrix,
sequential by nature: a Python loop over the positions carries (c, n, m,
h) (the reference's ``lax.scan``). It keeps its carries head-major, (H,
B, hd), so the recurrent product of a step is one batched matmul a head.

Both cells run at the model's width (n_heads x head_dim = d_model). The
stabiliser follows the xLSTM paper, m_t = max(log f_t + m_{t-1}, log i_t),
held at or above -80; the gates' logs and m are f32, the carries C, n, c,
h in the model's dtype, as in the reference. The reference's work here is
plain ``jnp`` (no Pallas kernel), so this is plain PyTorch too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import chunk_of

Params = dict[str, torch.Tensor]

# The floor of every stabiliser: exp() stays finite when all gates are tiny.
M_FLOOR = -80.0


def _scale(p: int) -> float:
    """1 / sqrt(p) rounded as the reference's f32 ``1.0 / jnp.sqrt(p)``."""
    return float(1.0 / torch.sqrt(torch.tensor(float(p))))


# ------------------------------------------------------------------- mLSTM
def _mlstm_chunk_scan(q, k, v, li, lf, chunk: int, return_state: bool = False):
    """Chunkwise mLSTM. q, k, v (B, S, H, p) in the model's dtype; li, lf
    (B, S, H) f32 log gates.

    The carry a head is C (p, p) and n (p,), both kept pre-scaled by
    exp(-m), and the running max m (f32, 0 at the start). Within a chunk
    the intra weights are W[i, j] = exp(F_i - F_j + li_j - m_i) for j <= i
    (-inf above the diagonal before the exp), with m_i = max(max_j(...),
    F_i + m_prev) so every exponent is <= 0. Returns y (B, S, H, p), and
    with ``return_state`` the carry (C (B, H, p, p), n (B, H, p), m (B,
    H)) after the last chunk."""
    b, s, h, p = q.shape
    c = chunk_of(s, chunk)
    above = ~torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    scale = _scale(p)
    cmat = torch.zeros((b, h, p, p), dtype=q.dtype, device=q.device)
    nvec = torch.zeros((b, h, p), dtype=q.dtype, device=q.device)
    m_prev = torch.zeros((b, h), dtype=torch.float32, device=q.device)
    ys = []
    # split once: the backward of a split is one cat, where a slice a chunk
    # would each give a zero-filled gradient of the whole sequence
    for qi, ki, vi, lii, lfi in zip(*(t.split(c, dim=1) for t in (q, k, v, li, lf))):
        fcum = torch.cumsum(lfi, dim=1)  # (B, c, H)
        # intra log weights (B, c_i, c_j, H)
        logw = fcum[:, :, None, :] - fcum[:, None, :, :] + lii[:, None, :, :]
        logw = logw.masked_fill(above[None, :, :, None], float("-inf"))
        m_intra = torch.amax(logw, dim=2)  # (B, c, H)
        m_inter = fcum + m_prev[:, None, :]
        m_i = torch.maximum(m_intra, m_inter).clamp_min(M_FLOOR)
        w = torch.exp(logw - m_i[:, :, None, :])  # (B, c, c, H)
        binter = torch.exp(m_inter - m_i)  # (B, c, H)

        scores = torch.einsum("bihp,bjhp->bijh", qi, ki) * scale  # (B, c, c, H)
        aw = scores * w.to(scores.dtype)
        qs = qi * scale
        y_num = torch.einsum("bijh,bjhp->bihp", aw, vi)
        bq = binter.to(qi.dtype)
        y_num = y_num + torch.einsum("bihp,bhpq->bihq", qs, cmat) * bq[..., None]
        denom = aw.sum(dim=2) + torch.einsum("bihp,bhp->bih", qs, nvec) * bq
        denom = torch.maximum(denom.abs(), torch.exp(-m_i).to(denom.dtype))
        ys.append(y_num / denom[..., None])

        # the carry update, scaled by exp(-m_next)
        ftot = fcum[:, -1, :]  # (B, H)
        tail = ftot[:, None, :] - fcum + lii  # (B, c, H)
        m_next = torch.maximum(ftot + m_prev, torch.amax(tail, dim=1)).clamp_min(M_FLOOR)
        kw = torch.exp(tail - m_next[:, None, :]).to(ki.dtype)
        decay = torch.exp(ftot + m_prev - m_next)  # (B, H)
        cmat = cmat * decay[..., None, None].to(cmat.dtype) + torch.einsum(
            "bihp,bihq->bhpq", ki * kw[..., None], vi)
        nvec = nvec * decay[..., None].to(nvec.dtype) + torch.einsum("bihp,bih->bhp", ki, kw)
        m_prev = m_next
    out = torch.cat(ys, dim=1)
    if return_state:
        return out, (cmat, nvec, m_prev)
    return out


def _mlstm_gates(p: Params, x: torch.Tensor, h: int):
    """(log input gate, log forget gate), f32, from x (B, S, D)."""
    gates = x @ p["w_if"] + p["b_if"]  # (B, S, 2H)
    return gates[..., :h].float(), F.logsigmoid(gates[..., h:].float())


def mlstm_train(p: Params, x: torch.Tensor, cfg: ModelConfig, return_state: bool = False):
    """The mLSTM layer over a sequence x (B, S, D) -> (B, S, D); with
    ``return_state`` also the carry (C, n, m) for decoding."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, h, hd)
    v = (x @ p["wv"]).reshape(b, s, h, hd)
    li, lf = _mlstm_gates(p, x, h)
    y = _mlstm_chunk_scan(q, k, v, li, lf, cfg.ssm_chunk, return_state=return_state)
    if return_state:
        y, state = y
    o = torch.sigmoid(x @ p["wo_gate"])
    out = (y.reshape(b, s, d) * o) @ p["wo"]
    if return_state:
        return out, state
    return out


def mlstm_decode(p: Params, x: torch.Tensor, cmat: torch.Tensor, nvec: torch.Tensor,
                 m: torch.Tensor, cfg: ModelConfig):
    """One token x (B, 1, D) against the carry: C (B, H, p, p) and n (B, H,
    p), both pre-scaled, and m (B, H) f32. Returns (y (B, 1, D), C', n',
    m'), the carry as new tensors."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, h, hd)
    k = (x @ p["wk"]).reshape(b, h, hd)
    v = (x @ p["wv"]).reshape(b, h, hd)
    li, lf = (g[:, 0] for g in _mlstm_gates(p, x, h))  # (B, H)
    m_next = torch.maximum(lf + m, li).clamp_min(M_FLOOR)
    fw = torch.exp(lf + m - m_next)[..., None]  # (B, H, 1)
    iw = torch.exp(li - m_next)[..., None]
    ki = k * iw.to(k.dtype)
    cmat = cmat * fw[..., None].to(cmat.dtype) + ki[..., :, None] * v[..., None, :]
    nvec = nvec * fw.to(nvec.dtype) + ki
    qs = q * _scale(hd)
    num = torch.einsum("bhp,bhpq->bhq", qs, cmat)
    den = torch.einsum("bhp,bhp->bh", qs, nvec).abs()
    den = torch.maximum(den, torch.exp(-m_next).to(den.dtype))
    y = (num / den[..., None]).reshape(b, 1, cfg.d_model)
    o = torch.sigmoid(x @ p["wo_gate"])
    return (y * o) @ p["wo"], cmat, nvec, m_next


# ------------------------------------------------------------------- sLSTM
def _recurrent_weights(r_gates: torch.Tensor) -> torch.Tensor:
    """r_gates (H, 4, p, q) as (H, p, 4q): a head's recurrent product of
    all four gates is one matmul."""
    h, g, p, q = r_gates.shape
    return r_gates.permute(0, 2, 1, 3).reshape(h, p, g * q)


def _slstm_cell(z, cst, nst, mst):
    """One sLSTM step from the gates' pre-activations z (4, ...) (input,
    forget, cell, output) and the carry: c, n in the model's dtype, m f32,
    all of z[0]'s shape. Returns (c', n', m', h')."""
    dt = cst.dtype
    zi, zf, zz, zo = z.unbind(0)
    zif = zi.float()
    zff = F.logsigmoid(zf.float())
    fm = zff + mst
    m_new = torch.maximum(fm, zif).clamp_min(M_FLOOR)
    iw = torch.exp(zif - m_new).to(dt)
    fw = torch.exp(fm - m_new).to(dt)
    cst = fw * cst + iw * torch.tanh(zz)
    nst = fw * nst + iw
    hst = torch.sigmoid(zo) * cst / nst.clamp_min(1e-6)
    return cst, nst, m_new, hst


def slstm_scan(pre: torch.Tensor, r_gates: torch.Tensor):
    """The sLSTM recurrence over a sequence: pre (B, S, 4, H, p) the input
    projections of the four gates, r_gates (H, 4, p, p). Returns (h (B, S,
    H, p) at every position, the carry (c, n, m, h) after the last, each
    (B, H, p)). One step a position: the recurrent product of the last h
    (one matmul a head), then ``_slstm_cell``."""
    b, _, _, h, p = pre.shape
    dt = pre.dtype
    rmat = _recurrent_weights(r_gates)
    # (4, H, B, p) a step, unbound once: the backward of an unbind is one
    # stack, where indexing a step would each give a zero-filled gradient
    # of the whole sequence
    steps = pre.permute(1, 2, 3, 0, 4).unbind(0)
    zeros = torch.zeros((h, b, p), dtype=dt, device=pre.device)
    cst, nst, hst = zeros, zeros, zeros
    mst = torch.zeros((h, b, p), dtype=torch.float32, device=pre.device)
    hs = []
    for pre_t in steps:
        rec = torch.bmm(hst, rmat).view(h, b, 4, p).permute(2, 0, 1, 3)  # (4, H, B, p)
        cst, nst, mst, hst = _slstm_cell(pre_t + rec, cst, nst, mst)
        hs.append(hst)
    carry = tuple(x.transpose(0, 1) for x in (cst, nst, mst, hst))
    return torch.stack(hs, dim=0).permute(2, 0, 1, 3), carry


def slstm_train(p: Params, x: torch.Tensor, cfg: ModelConfig, return_state: bool = False):
    """The sLSTM layer over a sequence x (B, S, D) -> (B, S, D); with
    ``return_state`` also the carry (c, n, m, h), each (B, H, hd)."""
    b, s, d = x.shape
    pre = (x @ p["w_gates"] + p["b_gates"]).reshape(b, s, 4, cfg.n_heads, cfg.head_dim)
    y, carry = slstm_scan(pre, p["r_gates"])
    out = y.reshape(b, s, d) @ p["wo"]
    if return_state:
        return out, carry
    return out


def slstm_decode(p: Params, x: torch.Tensor, cst, nst, mst, hst, cfg: ModelConfig):
    """One token x (B, 1, D) against the carry (c, n, m, h), each (B, H,
    hd). Returns (y (B, 1, D), c', n', m', h'), the carry as new tensors."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    pre = (x @ p["w_gates"] + p["b_gates"]).reshape(b, 4, h, hd)
    rec = torch.bmm(hst.transpose(0, 1), _recurrent_weights(p["r_gates"]))  # (H, B, 4hd)
    rec = rec.view(h, b, 4, hd).permute(1, 2, 0, 3)  # (B, 4, H, hd)
    cst, nst, mst, hst = _slstm_cell((pre + rec).transpose(0, 1), cst, nst, mst)
    y = hst.reshape(b, 1, cfg.d_model) @ p["wo"]
    return y, cst, nst, mst, hst
