"""RNN-T (transducer) loss: the K3 lattice sweeps and their plain versions.

Counterpart of espnet_tpu/ops/rnnt.py (``rnnt_loss``, ``rnnt_loss_auto``)
and of espnet_tpu/ops/pallas/rnnt_kernel.py (``rnnt_loss_fused``), which
the JAX package selects on the TPU.

- ``rnnt_loss_plain``: the JAX package's diagonal scan in torch, whose
  gradient is autograd. It is the tests' oracle.
- ``rnnt_loss``: a ``torch.autograd.Function``. Its forward forms the
  blank and emit lattices in torch (log-softmax over V, the blank column
  and the label entries, masked to -1e30 outside each sample's lengths)
  and runs the alpha sweep; it saves alpha. Its backward runs the beta
  sweep once and assembles the closed-form gradient of the logits from
  one-hot products (no scatter, no atomics):
  ``dlogits = onehot(blank) g_blank + onehot(label) g_emit
  - softmax (g_blank + g_emit)``.
- ``rnnt_alpha`` and ``rnnt_beta`` are the sweeps' wrappers: on a CUDA
  tensor they launch the kernels of csrc/rnnt.cu (and never run the plain
  sweeps), on a CPU tensor ``rnnt_alpha_plain`` and ``rnnt_beta_plain``,
  the same sweeps as torch loops over the anti-diagonals.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from espnet_tpu_torch.ops import _cuda
from espnet_tpu_torch.ops.losses import at_least_fp32

NEG_INF = -1e30
# the kernels keep a diagonal in registers: at most 32 cells a lane, in a
# block of at most 32 warps of 32 lanes
MAX_U1 = 32 * 32 * 32


def _reduce(nll, reduction: str):
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def rnnt_loss_plain(logits, labels, logit_lens, label_lens,
                    blank_id: int = 0, reduction: str = "mean"):
    """Transducer negative log likelihood by a scan over the anti-diagonals
    of the (T, U+1) lattice; logits (B, T, U+1, V), labels (B, U)
    0-padded, lengths (B,). Its gradient is torch's autograd."""
    B, T, U1, V = logits.shape
    U = U1 - 1
    logp = torch.log_softmax(at_least_fp32(logits), dim=-1)
    blank_lp = logp[..., blank_id]
    emit_lp = logp[:, :, :U, :].gather(
        3, labels.long()[:, None, :, None].expand(B, T, U, 1))[..., 0]
    u = torch.arange(U1, device=logits.device)
    neg = torch.full((B, 1), NEG_INF, device=logits.device)
    alpha = torch.full((B, U1), NEG_INF, device=logits.device)
    alphas = []
    for d in range(T + U):
        t = d - u
        bl = blank_lp[:, (t - 1).clamp(0, T - 1), u]
        from_blank = torch.where((t - 1 >= 0) & (t - 1 < T), alpha + bl,
                                 NEG_INF)
        em = emit_lp[:, t[1:].clamp(0, T - 1), u[1:] - 1]
        prev = torch.cat([neg, alpha[:, :-1]], dim=1)
        from_emit = torch.where((u >= 1) & (t >= 0) & (t < T),
                                prev + torch.cat([neg, em], dim=1), NEG_INF)
        alpha = torch.logaddexp(from_blank, from_emit)
        if d == 0:
            alpha = torch.where(u == 0, 0.0, alpha)
        alpha = torch.where((t >= 0) & (t < T), alpha, NEG_INF)
        alphas.append(alpha)
    alphas = torch.stack(alphas)                       # (T + U, B, U1)
    b = torch.arange(B, device=logits.device)
    d_idx = (logit_lens - 1 + label_lens).clamp(0, T + U - 1)
    final_alpha = alphas[d_idx, b, label_lens]
    final_blank = blank_lp[b, (logit_lens - 1).clamp(min=0), label_lens]
    return _reduce(-(final_alpha + final_blank), reduction)


def lattices(logits, labels, logit_lens, label_lens, blank_id: int = 0):
    """-> blank_lp, emit_lp (B, T, U+1) f32: log p(blank | t, u) and
    log p(y_{u+1} | t, u), -1e30 outside each sample's lengths (and emit
    at u = U_b). As espnet_tpu/ops/pallas/rnnt_kernel.py:_lattices."""
    B, T, U1, V = logits.shape
    U = U1 - 1
    logp = torch.log_softmax(at_least_fp32(logits), dim=-1)
    blank_lp = logp[..., blank_id]
    emit_lp = logp[:, :, :U, :].gather(
        3, labels.long()[:, None, :, None].expand(B, T, U, 1))[..., 0]
    emit_lp = F.pad(emit_lp, (0, 1), value=NEG_INF)
    t_ok = (torch.arange(T, device=logits.device)[None, :, None]
            < logit_lens[:, None, None])
    u_idx = torch.arange(U1, device=logits.device)[None, None, :]
    blank_lp = torch.where(t_ok & (u_idx <= label_lens[:, None, None]),
                           blank_lp, NEG_INF)
    emit_lp = torch.where(t_ok & (u_idx < label_lens[:, None, None]),
                          emit_lp, NEG_INF)
    return blank_lp, emit_lp


def _clamped_lengths(blank, tlen, ulen):
    _, T, U1 = blank.shape
    return tlen.clamp(0, T), ulen.clamp(0, U1 - 1)


def _unskew(diags, T: int, U1: int):
    """(D, B, U1) diagonals -> (B, T, U1), cell (t, u) from diagonal t+u."""
    u = torch.arange(U1, device=diags.device)
    d = torch.arange(T, device=diags.device)[:, None] + u[None, :]
    return diags[d, :, u[None, :]].permute(2, 0, 1)


def rnnt_alpha_plain(blank, emit, tlen, ulen):
    """The alpha sweep in torch: -> alpha (B, T, U+1), -1e30 outside
    t < T_b, u <= U_b, and nll (B,) = -(alpha + blank) at the exit cell
    (T_b - 1, U_b); 1e30 where T_b < 1."""
    B, T, U1 = blank.shape
    Tb, Ub = _clamped_lengths(blank, tlen, ulen)
    u = torch.arange(U1, device=blank.device)
    neg = torch.full((B, 1), NEG_INF, device=blank.device)
    prev = torch.full((B, U1), NEG_INF, device=blank.device)
    diags = []
    for d in range(T + U1 - 1):
        t = d - u
        inside = ((t >= 0)[None] & (t[None] < Tb[:, None])
                  & (u[None] <= Ub[:, None]))
        if d == 0:
            a = torch.where(u == 0, 0.0, NEG_INF).expand(B, U1)
        else:
            from_blank = torch.where(
                (t >= 1)[None], prev + blank[:, (t - 1).clamp(0, T - 1), u],
                NEG_INF)
            from_emit = torch.where(
                (u >= 1)[None], torch.cat([neg, prev[:, :-1]], dim=1)
                + emit[:, t.clamp(0, T - 1), (u - 1).clamp(min=0)], NEG_INF)
            a = torch.logaddexp(from_blank, from_emit)
        prev = torch.where(inside, a, NEG_INF)
        diags.append(prev)
    alpha = _unskew(torch.stack(diags), T, U1)
    b = torch.arange(B, device=blank.device)
    t_exit = (Tb - 1).clamp(min=0)
    nll = -(alpha[b, t_exit, Ub] + blank[b, t_exit, Ub])
    return alpha, torch.where(Tb >= 1, nll, -NEG_INF)


def rnnt_beta_plain(blank, emit, tlen, ulen):
    """The beta sweep in torch: -> beta (B, T, U+1), the log-probability
    of completing from (t, u) through the exit (T_b - 1, U_b); -1e30
    outside t < T_b, u <= U_b."""
    B, T, U1 = blank.shape
    Tb, Ub = _clamped_lengths(blank, tlen, ulen)
    u = torch.arange(U1, device=blank.device)
    neg = torch.full((B, 1), NEG_INF, device=blank.device)
    nxt = torch.full((B, U1), NEG_INF, device=blank.device)
    diags = []
    for d in range(T + U1 - 2, -1, -1):
        t = d - u
        inside = ((t >= 0)[None] & (t[None] < Tb[:, None])
                  & (u[None] <= Ub[:, None]))
        last = t[None] == (Tb - 1)[:, None]
        after_blank = torch.where(
            last, torch.where(u[None] == Ub[:, None], 0.0, NEG_INF), nxt)
        after_emit = torch.where(u[None] < Ub[:, None],
                                 torch.cat([nxt[:, 1:], neg], dim=1),
                                 NEG_INF)
        tc = t.clamp(0, T - 1)
        v = torch.logaddexp(blank[:, tc, u] + after_blank,
                            emit[:, tc, u] + after_emit)
        nxt = torch.where(inside, v, NEG_INF)
        diags.append(nxt)
    return _unskew(torch.stack(diags[::-1]), T, U1)


def _check_sweep_args(name, blank, emit, tlen, ulen):
    if blank.dim() != 3 or blank.shape != emit.shape:
        raise ValueError(f"{name}: need blank and emit lattices of one "
                         f"(B, T, U+1) shape, got {tuple(blank.shape)} and "
                         f"{tuple(emit.shape)}")
    if blank.dtype != torch.float32 or emit.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes float32 lattices")
    B, T, U1 = blank.shape
    if tlen.shape != (B,) or ulen.shape != (B,):
        raise ValueError(f"{name}: need (B,) lengths")
    # the lattice indices the kernel forms stay below (T + 2 (U+1)) (U+1)
    if not 1 <= U1 <= MAX_U1 or T < 1 or (T + 2 * U1) * U1 >= 2 ** 31:
        raise ValueError(f"{name}: the kernel takes T >= 1, 1 <= U+1 "
                         f"<= {MAX_U1} and (T + 2 (U+1)) (U+1) < 2^31, got "
                         f"T={T}, U+1={U1}")
    for x in (emit, tlen, ulen):
        if x.device != blank.device:
            raise ValueError(f"{name}: all inputs on one device")
    return (blank.contiguous(), emit.contiguous(),
            tlen.to(torch.int32).contiguous(),
            ulen.to(torch.int32).contiguous())


def _on_card(name, blank):
    if blank.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {blank.device}")


def rnnt_alpha(blank, emit, tlen, ulen):
    """The alpha sweep: K3's ``rnnt_alpha`` on a CUDA tensor, the plain
    version on a CPU one. -> alpha (B, T, U+1), nll (B,)."""
    if blank.device.type == "cpu":
        return rnnt_alpha_plain(blank, emit, tlen, ulen)
    _on_card("rnnt_alpha", blank)
    blank, emit, tlen, ulen = _check_sweep_args("rnnt_alpha", blank, emit,
                                                tlen, ulen)
    B, T, U1 = blank.shape
    alpha = torch.empty_like(blank)
    nll = torch.empty(B, dtype=torch.float32, device=blank.device)
    err = _cuda.lib().rnnt_alpha(
        blank.data_ptr(), emit.data_ptr(), tlen.data_ptr(), ulen.data_ptr(),
        alpha.data_ptr(), nll.data_ptr(), B, T, U1,
        _cuda.stream_ptr(blank.device))
    _cuda.check(err, "rnnt_alpha")
    _cuda.LAUNCHES["rnnt_alpha"] += 1
    return alpha, nll


def rnnt_beta(blank, emit, tlen, ulen):
    """The beta sweep: K3's ``rnnt_beta`` on a CUDA tensor, the plain
    version on a CPU one. -> beta (B, T, U+1)."""
    if blank.device.type == "cpu":
        return rnnt_beta_plain(blank, emit, tlen, ulen)
    _on_card("rnnt_beta", blank)
    blank, emit, tlen, ulen = _check_sweep_args("rnnt_beta", blank, emit,
                                                tlen, ulen)
    B, T, U1 = blank.shape
    beta = torch.empty_like(blank)
    err = _cuda.lib().rnnt_beta(
        blank.data_ptr(), emit.data_ptr(), tlen.data_ptr(), ulen.data_ptr(),
        beta.data_ptr(), B, T, U1, _cuda.stream_ptr(blank.device))
    _cuda.check(err, "rnnt_beta")
    _cuda.LAUNCHES["rnnt_beta"] += 1
    return beta


def rnnt_grad(logits, labels, blank_lp, emit_lp, alpha, beta, nll, tlen,
              ulen, blank_id: int = 0):
    """The closed-form gradient of each sample's nll with respect to its
    logits (B, T, U+1, V), from the two sweeps (espnet_tpu/ops/pallas/
    rnnt_kernel.py:_bwd): the occupancy of each edge out of (t, u) is
    exp(alpha + edge + beta(next) + nll); an edge whose lattice entry is
    masked gets none."""
    B, T, U1, V = logits.shape
    U = U1 - 1
    Tb, Ub = _clamped_lengths(blank_lp, tlen, ulen)
    logz = -nll[:, None, None]
    t_idx = torch.arange(T, device=logits.device)[None, :, None]
    u_idx = torch.arange(U1, device=logits.device)[None, None, :]
    exit_cell = (t_idx + 1 == Tb[:, None, None]) & (u_idx
                                                    == Ub[:, None, None])
    beta_t1 = torch.where(exit_cell, 0.0, F.pad(beta[:, 1:], (0, 0, 0, 1),
                                                 value=NEG_INF))
    beta_u1 = F.pad(beta[:, :, 1:], (0, 1), value=NEG_INF)
    g_blank = -torch.exp(alpha + blank_lp + beta_t1 - logz)
    g_emit = -torch.exp(alpha + emit_lp + beta_u1 - logz)
    g_blank = torch.where(blank_lp <= NEG_INF / 2, 0.0, g_blank)
    g_emit = torch.where(emit_lp <= NEG_INF / 2, 0.0, g_emit)
    sm = torch.softmax(at_least_fp32(logits), dim=-1)
    oh_blank = F.one_hot(torch.full((), blank_id, device=sm.device),
                         V).to(sm)
    oh_label = F.one_hot(labels.long(), V).to(sm)      # (B, U, V)
    dlogits = (g_blank[..., None] * oh_blank
               - sm * (g_blank + g_emit)[..., None])
    emit_part = g_emit[:, :, :U, None] * oh_label[:, None]
    return dlogits + F.pad(emit_part, (0, 0, 0, 1))


class _RNNTLoss(torch.autograd.Function):
    """Per-sample nll (B,); forward: alpha sweep, backward: beta sweep and
    the closed form. Alpha is saved, not swept again."""

    @staticmethod
    def forward(ctx, logits, labels, logit_lens, label_lens, blank_id):
        blank_lp, emit_lp = lattices(logits, labels, logit_lens, label_lens,
                                     blank_id)
        alpha, nll = rnnt_alpha(blank_lp, emit_lp, logit_lens, label_lens)
        ctx.blank_id = blank_id
        ctx.save_for_backward(logits, labels, logit_lens, label_lens,
                              blank_lp, emit_lp, alpha, nll)
        return nll

    @staticmethod
    def backward(ctx, g):
        (logits, labels, logit_lens, label_lens, blank_lp, emit_lp, alpha,
         nll) = ctx.saved_tensors
        beta = rnnt_beta(blank_lp, emit_lp, logit_lens, label_lens)
        dlogits = rnnt_grad(logits, labels, blank_lp, emit_lp, alpha, beta,
                            nll, logit_lens, label_lens, ctx.blank_id)
        dlogits = dlogits * g[:, None, None, None]
        return dlogits.to(logits.dtype), None, None, None, None


def rnnt_loss(logits, labels, logit_lens, label_lens, blank_id: int = 0,
              reduction: str = "mean"):
    """Transducer negative log likelihood through the lattice sweeps (K3
    on the card); logits (B, T, U+1, V), labels (B, U) 0-padded."""
    nll = _RNNTLoss.apply(logits, labels, logit_lens, label_lens, blank_id)
    return _reduce(nll, reduction)
