"""Wrapper of Kimi Delta Attention's chunked recurrence (``csrc/kda.cu``)
beside its plain PyTorch versions.

The kernel replaces no TPU kernel: the JAX package has no transformer. It
is the core of :func:`~..models.kda.kda_attention`: per sequence and head
(``d`` = 128 dims of q, k and v), with the state ``S [d, d]`` zero at each
sequence's start::

    S_t = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t * scale

on feature-major tensors: ``q``, ``k``, ``v`` ``[heads * d, tokens]`` (q
and k L2-normed per head), the log-decay ``g`` ``[heads * d, tokens]``
(every value at most 0) and ``beta [heads, tokens]``; ``batch`` sequences
of equal length packed along the tokens.

* :func:`kda_recurrent_plain` is the token recurrence itself: a loop over
  the positions of a sequence, every sequence and head at once. The tests
  hold the other two to it (in float64 where they can).
* :func:`kda_chunk_plain` is the exact chunked form that the kernel
  computes, in PyTorch: chunks of :data:`CHUNK` tokens, each chunk's
  transform from its own tokens (the pairwise decays ``exp(Gam_r - Gam_s)``
  formed directly, never as ``exp(Gam_r) * exp(-Gam_s)``, which overflows
  once a chunk's decay passes float32's exp range), then a loop over the
  chunks that carries the state. It runs in the dtype of ``g``.
* :func:`kda_chunk_cuda` launches the kernel: bf16 q, k, v, float32 g and
  beta, the state in float32, bf16 o. ``csrc/kda.cu`` says how.

The same library holds the block's glue, each one pass beside its plain
version (float32 inside, one bf16 rounding): :func:`kda_conv_cuda` (the
short convolution, SiLU and the q and k L2 norms), :func:`kda_decay_cuda`
(the log-decay from the low-rank product) and :func:`kda_gate_norm_cuda`
(the gated output norm). Each launcher counts its launches (``launches``)
and a trace counter (``kda.kernel``, ``kda.conv``, ``kda.decay``,
``kda.gate_norm``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ... import _build
from ...utils import trace

# (q, k, v, g, beta, work, o, heads, batch, seq, scale, device, stream)
KDA_CHUNK = _build.Entry("kda", "kda_chunk_launch",
                         "ppppppp" "iii" "f" "i" "p")
# (x, w, out, rows, normed rows, tokens, seq, eps, device, stream)
KDA_CONV = _build.Entry("kda", "kda_conv_launch", "ppp" "iiii" "f" "i" "p")
# (f, a_log, dt_bias, g, rows, tokens, device, stream)
KDA_DECAY = _build.Entry("kda", "kda_decay_launch", "pppp" "ii" "i" "p")
# (o, gate, w, y, rows, tokens, eps, device, stream)
KDA_GATE_NORM = _build.Entry("kda", "kda_gate_norm_launch",
                             "pppp" "ii" "f" "i" "p")
HEAD_DIM = 128  # the kernel's d of q, k and v
CHUNK = 64  # tokens a chunk
# floats of the kernel's work a (sequence, head, chunk): W2^T and Q~^T,
# W1, K^, P^T, exp(Gam_C) (csrc/kda.cu: kWork)
WORK_FLOATS = HEAD_DIM * HEAD_DIM + 2 * CHUNK * HEAD_DIM + CHUNK * CHUNK + \
    HEAD_DIM
# pairwise decays a block of the plain chunked form holds, at most
PLAIN_PAIRS = 1 << 24


def heads_major(x: torch.Tensor, heads: int, batch: int) -> torch.Tensor:
    """Feature-major ``[heads * dim, batch * seq]`` as ``[batch, heads,
    seq, dim]`` (a view)."""
    dim, seq = x.shape[0] // heads, x.shape[1] // batch
    return x.view(heads, dim, batch, seq).permute(2, 0, 3, 1)


def feature_major(o: torch.Tensor) -> torch.Tensor:
    """``[batch, heads, seq, dim]`` back to ``[heads * dim, batch * seq]``."""
    b, h, s, d = o.shape
    return o.permute(1, 3, 0, 2).reshape(h * d, b * s)


def kda_recurrent_plain(q, k, v, g, beta, batch: int,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The token recurrence, in the dtype of ``g``: ``o`` feature-major
    ``[heads * d, tokens]``. A loop over a sequence's positions (every
    sequence and head at once); the tests' yardstick, not a path of the
    model."""
    heads = beta.shape[0]
    dt = g.dtype
    qh, kh, vh, gh = (heads_major(t, heads, batch).to(dt)
                      for t in (q, k, v, g))
    bh = beta.to(dt).view(heads, batch, -1).permute(1, 0, 2)
    d, dv = qh.shape[-1], vh.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    state = qh.new_zeros((batch, heads, d, dv))
    out = []
    for t in range(qh.shape[2]):
        state = state * gh[:, :, t, :, None].exp()
        kt, bt = kh[:, :, t], bh[:, :, t, None]
        u = bt * (vh[:, :, t] - torch.einsum("bhd,bhdv->bhv", kt, state))
        state = state + kt[..., None] * u[:, :, None, :]
        out.append(torch.einsum("bhd,bhdv->bhv", qh[:, :, t], state) * scale)
    return feature_major(torch.stack(out, dim=2))


def chunk_transform(qc, kc, vc, gc, bc, scale: float):
    """One chunk's part that needs no state, for chunks ``[..., C, d]``
    (``bc [..., C]``): ``(w1, w2, qt, kt, p, last)`` with ``U = w1 - w2
    S``, ``O = qt S + p U`` and ``S' = last . S + kt^T U`` (``last`` the
    chunk's whole decay ``exp(Gam_C)``, along d)."""
    gam = gc.cumsum(-2)
    c = gam.shape[-2]
    pos = torch.arange(c, device=gam.device)
    below = pos[None, :] <= pos[:, None]  # [r, s]: s <= r
    diff = gam[..., :, None, :] - gam[..., None, :, :]  # [.., r, s, d]
    decay = torch.where(below[..., None], diff,
                        diff.new_full((), float("-inf"))).exp_()
    kd = decay * kc[..., None, :, :]  # k_s exp(Gam_r - Gam_s)
    a = torch.einsum("...rd,...rsd->...rs", kc, kd)
    p = torch.einsum("...rd,...rsd->...rs", qc, kd) * scale
    del decay, kd
    a = (a * bc[..., :, None]).tril(-1)
    eye = torch.eye(c, dtype=a.dtype, device=a.device)
    rhs = torch.cat([vc, gam.exp() * kc], dim=-1) * bc[..., None]
    x = torch.linalg.solve_triangular(eye + a, rhs, upper=False,
                                      unitriangular=True)
    dv = vc.shape[-1]
    last = gam[..., -1:, :]
    qt = qc * gam.exp() * scale
    kt = kc * (last - gam).exp()
    return x[..., :dv], x[..., dv:], qt, kt, p, last.exp()


def kda_chunk_plain(q, k, v, g, beta, batch: int,
                    scale: Optional[float] = None,
                    state_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """The chunked form in the dtype of ``g`` (float32 on the model's CPU
    path): each chunk's transform (:func:`chunk_transform`, chunks in
    blocks of at most :data:`PLAIN_PAIRS` pairwise decays), then one step a
    chunk carrying the state, rounded to ``state_dtype`` after each chunk
    where one is given (a precision below the kernel's, which its
    tolerances must refuse). ``o`` feature-major ``[heads * d,
    tokens]``."""
    heads = beta.shape[0]
    dt = g.dtype
    qh, kh, vh, gh = (heads_major(t, heads, batch).to(dt)
                      for t in (q, k, v, g))
    bh = beta.to(dt).view(heads, batch, -1).permute(1, 0, 2)
    b, h, seq, d = qh.shape
    dv = vh.shape[-1]
    if seq % CHUNK:
        raise ValueError(f"kda: sequence {seq} is not a multiple of the "
                         f"chunk {CHUNK}")
    n = seq // CHUNK
    scale = d ** -0.5 if scale is None else scale

    def chunks(t):
        return t.reshape(b * h * n, CHUNK, t.shape[-1])

    qc, kc, vc, gc = (chunks(t) for t in (qh, kh, vh, gh))
    bc = bh.reshape(b * h * n, CHUNK)
    step = max(1, PLAIN_PAIRS // (CHUNK * CHUNK * d))
    parts = [chunk_transform(qc[i:i + step], kc[i:i + step],
                             vc[i:i + step], gc[i:i + step],
                             bc[i:i + step], scale)
             for i in range(0, qc.shape[0], step)]
    w1, w2, qt, kt, p, last = (
        torch.cat([part[j] for part in parts]).view(
            b * h, n, *parts[0][j].shape[1:]) for j in range(6))
    state = qh.new_zeros((b * h, d, dv))
    out = []
    for c in range(n):
        u = w1[:, c] - w2[:, c] @ state
        out.append(qt[:, c] @ state + p[:, c] @ u)
        state = last[:, c].transpose(-1, -2) * state + \
            kt[:, c].transpose(-1, -2) @ u
        if state_dtype is not None:
            state = state.to(state_dtype).to(dt)
    o = torch.stack(out, dim=1).view(b, h, seq, dv)
    return feature_major(o)


def kda_chunk_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, beta: torch.Tensor, batch: int,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel: a new bf16 ``o [heads * 128, tokens]``. ``q``,
    ``k``, ``v`` bf16 and ``g`` float32 ``[heads * 128, tokens]``, ``beta``
    float32 ``[heads, tokens]``, each contiguous on one card; ``batch``
    sequences of a multiple of :data:`CHUNK` tokens each."""
    if not q.is_cuda:
        raise ValueError("kda_chunk_cuda needs CUDA tensors")
    for name, t, dtype in (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
                           ("v", v, torch.bfloat16), ("g", g, torch.float32),
                           ("beta", beta, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"kda: {name} must be {dtype}, not {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"kda: {name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"kda: {name} must be contiguous, got strides "
                             f"{t.stride()}")
        if t.device != q.device:
            raise ValueError(f"kda: {name} is on {t.device}, q on "
                             f"{q.device}")
    heads, tokens = beta.shape
    if heads < 1 or q.shape[0] != heads * HEAD_DIM:
        raise ValueError(f"kda: the kernel takes a head dim of {HEAD_DIM}, "
                         f"got {q.shape[0]} rows of q over {heads} heads")
    for name, t in (("k", k), ("v", v), ("g", g)):
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"kda: {name} must have q's shape "
                             f"{tuple(q.shape)}, got {tuple(t.shape)}")
    if q.shape[1] != tokens:
        raise ValueError(f"kda: beta has {tokens} tokens, q {q.shape[1]}")
    if batch < 1 or tokens % batch or (tokens // batch) % CHUNK:
        raise ValueError(f"kda: {tokens} tokens are not {batch} sequences "
                         f"of a multiple of {CHUNK} tokens")
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        if t.data_ptr() % 16:
            raise ValueError(f"kda: {name} must be 16-byte aligned")
    _build.refuse_grad("kda", q, k, v, g, beta)
    seq = tokens // batch
    scale = HEAD_DIM ** -0.5 if scale is None else scale
    work = torch.empty(batch * heads * (seq // CHUNK) * WORK_FLOATS,
                       dtype=torch.float32, device=q.device)
    o = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    KDA_CHUNK(q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
              g.data_ptr(), beta.data_ptr(), work.data_ptr(), o.data_ptr(),
              heads, batch, seq, scale)
    kda_chunk_cuda.launches += 1
    trace.count("kda.kernel")
    return o


kda_chunk_cuda.launches = 0


# --- the block's glue --------------------------------------------------------

def kda_conv_plain(x: torch.Tensor, w: torch.Tensor, batch: int,
                   normed: int, eps: float, d: int = HEAD_DIM
                   ) -> torch.Tensor:
    """SiLU of the causal depthwise convolution of feature-major ``x
    [channels, batch * seq]`` by ``w [channels, width]`` along each
    sequence's positions (zeros before position 0), then the first
    ``normed`` rows times ``rsqrt(sum x^2 + eps)`` over each head's ``d``
    rows and token; float32 inside, bf16 out."""
    ch, t = x.shape
    seq, width = t // batch, w.shape[1]
    xs = torch.nn.functional.pad(x.float().view(ch, batch, seq),
                                 (width - 1, 0))
    y = torch.zeros((ch, batch, seq), dtype=torch.float32, device=x.device)
    for j in range(width):
        y = y + xs[..., j:j + seq] * w[:, j, None, None].float()
    y = torch.nn.functional.silu(y).view(ch, t)
    if normed:
        yh = y[:normed].view(-1, d, t)
        yh *= yh.square().sum(1, keepdim=True).add_(eps).rsqrt_()
    return y.to(torch.bfloat16)


def kda_decay_plain(f: torch.Tensor, a_log: torch.Tensor,
                    dt_bias: torch.Tensor) -> torch.Tensor:
    """The log-decay ``-exp(a_log[h]) * softplus(f + dt_bias)`` of ``f
    [heads * d, tokens]`` (bf16), float32."""
    heads, t = a_log.shape[0], f.shape[1]
    x = f.float().view(heads, -1, t) + dt_bias.float().view(heads, -1, 1)
    g = torch.nn.functional.softplus(x).mul_(
        -a_log.float().exp().view(heads, 1, 1))
    return g.view(f.shape)


def kda_gate_norm_plain(o: torch.Tensor, gate: torch.Tensor,
                        w: torch.Tensor, eps: float) -> torch.Tensor:
    """``RMSNorm_d(o) * w * sigmoid(gate)`` per head and token of ``o``,
    ``gate [heads * d, tokens]`` (d = ``w``'s length), in float32, bf16
    out."""
    t, d = o.shape[1], w.shape[0]
    oh = o.view(-1, d, t).float()
    r = oh.square().mean(1, keepdim=True).add_(eps).rsqrt_()
    y = (oh * r).mul_(w.float().view(1, -1, 1)).mul_(
        torch.sigmoid(gate.view(-1, d, t).float()))
    return y.to(torch.bfloat16).view(o.shape)


def _glue_operands(name: str, tensors, rows: int, tokens: int) -> None:
    """Refuse what the glue kernels do not take: ``tensors`` are ``(name,
    tensor, dtype, shape)``, contiguous on one card."""
    dev = tensors[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors")
    for what, t, dtype, shape in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: {what} must be {dtype}, not {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {what} must have shape "
                             f"{tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name}: {what} is on {t.device}, not {dev}")
    if rows % HEAD_DIM:
        raise ValueError(f"{name}: {rows} rows are not heads of {HEAD_DIM}")


def kda_conv_cuda(x: torch.Tensor, w: torch.Tensor, batch: int,
                  normed: int, eps: float) -> torch.Tensor:
    """Launch the conv kernel: :func:`kda_conv_plain`'s result, a new bf16
    ``[channels, tokens]``. ``x`` bf16 ``[channels, batch * seq]``, ``w``
    bf16 ``[channels, 4]``; channels and ``normed`` multiples of 128, each
    sequence whole 64-token tiles."""
    rows, tokens = x.shape
    _glue_operands("kda_conv", [("x", x, torch.bfloat16, (rows, tokens)),
                                ("w", w, torch.bfloat16, (rows, 4))],
                   rows, tokens)
    if batch < 1 or tokens % batch or (tokens // batch) % CHUNK:
        raise ValueError(f"kda_conv: {tokens} tokens are not {batch} "
                         f"sequences of a multiple of {CHUNK} tokens")
    if normed % HEAD_DIM or not 0 <= normed <= rows:
        raise ValueError(f"kda_conv: normed {normed} rows")
    if x.data_ptr() % 16:
        raise ValueError("kda_conv: x must be 16-byte aligned")
    out = torch.empty_like(x)
    KDA_CONV(x.get_device(), x.data_ptr(), w.data_ptr(), out.data_ptr(),
             rows, normed, tokens, tokens // batch, eps)
    kda_conv_cuda.launches += 1
    trace.count("kda.conv")
    return out


kda_conv_cuda.launches = 0


def kda_decay_cuda(f: torch.Tensor, a_log: torch.Tensor,
                   dt_bias: torch.Tensor) -> torch.Tensor:
    """Launch the decay kernel: :func:`kda_decay_plain`'s result, a new
    float32 ``[heads * 128, tokens]``. ``f`` bf16, ``a_log`` float32
    ``[heads]``, ``dt_bias`` float32 ``[heads * 128]``; tokens % 8 == 0."""
    rows, tokens = f.shape
    _glue_operands("kda_decay", [
        ("f", f, torch.bfloat16, (rows, tokens)),
        ("a_log", a_log, torch.float32, (rows // HEAD_DIM,)),
        ("dt_bias", dt_bias, torch.float32, (rows,))], rows, tokens)
    if tokens % 8 or f.data_ptr() % 16:
        raise ValueError("kda_decay: needs tokens % 8 == 0 and f 16-byte "
                         "aligned")
    g = torch.empty(f.shape, dtype=torch.float32, device=f.device)
    KDA_DECAY(f.get_device(), f.data_ptr(), a_log.data_ptr(),
              dt_bias.data_ptr(), g.data_ptr(), rows, tokens)
    kda_decay_cuda.launches += 1
    trace.count("kda.decay")
    return g


kda_decay_cuda.launches = 0


def kda_gate_norm_cuda(o: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """Launch the gated norm kernel: :func:`kda_gate_norm_plain`'s result,
    a new bf16 ``[heads * 128, tokens]``. ``o`` and ``gate`` bf16, ``w``
    bf16 ``[128]``; tokens % 64 == 0."""
    rows, tokens = o.shape
    _glue_operands("kda_gate_norm", [
        ("o", o, torch.bfloat16, (rows, tokens)),
        ("gate", gate, torch.bfloat16, (rows, tokens)),
        ("w", w, torch.bfloat16, (HEAD_DIM,))], rows, tokens)
    if tokens % CHUNK:
        raise ValueError(f"kda_gate_norm: tokens {tokens} % {CHUNK} != 0")
    y = torch.empty_like(o)
    KDA_GATE_NORM(o.get_device(), o.data_ptr(), gate.data_ptr(),
                  w.data_ptr(), y.data_ptr(), rows, tokens, eps)
    kda_gate_norm_cuda.launches += 1
    trace.count("kda.gate_norm")
    return y


kda_gate_norm_cuda.launches = 0
