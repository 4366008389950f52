"""State-space / recurrent mixers: Mamba (selective scan), xLSTM (mLSTM, sLSTM).

All three expose, as the reference's `src/repro/models/ssm.py` does:
  init_*(generator, cfg)                    -> params
  *_forward(p, x, cfg, return_state=False)  -> y (and the final state)
  *_decode_step(p, x_t, state, cfg)         -> (y_t, state) (one token)
  *_init_state(batch, cfg, device, dtype)   -> state NamedTuple

Sequence forwards run the time recurrence in chunks of `SCAN_CHUNK` steps,
each chunk checkpointed while autograd records (about sqrt(T) of the
residuals kept for the backward pass), as the reference's
`_chunked_time_scan`. The reference pads the last chunk with steps that
leave the carry unchanged (`lax.scan` needs one shape); the port loops over
the T real steps only, so its last chunk is shorter and the outputs and
final state are the same. States are exact: the decode step continues any
prefix the sequence forward processed. Every state leaf is its own tensor
with the batch on axis 0, so a server can copy one row of each in place.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.distributed.dtensor import (elementwise, reduced,
                                           rows_and_heads, split_last)
from repro_torch.models.layers import _normal, apply_activation

Params = Dict[str, torch.Tensor]
SCAN_CHUNK = 128


def _silu(x: torch.Tensor) -> torch.Tensor:
    return apply_activation(x, "silu")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: log(1 + e^x) = max(x, 0) + log1p(e^-|x|), with
    no linear cut-off (F.softplus returns x above its threshold)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _scan(step, carry, xs, T: int):
    """Run `step(carry, inputs_t) -> (carry, y_t)` over t < T (inputs are
    time-major [T, ...]); returns (final carry, ys stacked on axis 1).
    The steps run in chunks of `SCAN_CHUNK` (read at each call); while
    autograd records and an input or carry leaf requires grad, each chunk
    is checkpointed: its residuals are recomputed in the backward pass
    from the chunk's carry, so the pass keeps one carry a chunk and one
    chunk's residuals."""
    leaves = list(carry) if isinstance(carry, tuple) else [carry]
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in leaves + list(xs))
    ys = []
    for t0 in range(0, T, SCAN_CHUNK):
        part = [a[t0:min(t0 + SCAN_CHUNK, T)] for a in xs]
        if remat:
            carry, y = torch.utils.checkpoint.checkpoint(
                _scan_steps, step, carry, part, use_reentrant=False)
        else:
            carry, y = _scan_steps(step, carry, part)
        ys.append(y)
    return carry, torch.cat(ys, dim=1)


def _scan_steps(step, carry, xs):
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(a[t] for a in xs))
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


# ===========================================================================
# Mamba (selective SSM)
# ===========================================================================

class MambaState(NamedTuple):
    conv: torch.Tensor   # [B, d_conv-1, d_inner] trailing conv inputs
    ssm: torch.Tensor    # [B, d_inner, d_state] float32


def _mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    m = cfg.mamba or MambaConfig()
    di = m.expand * cfg.d_model
    dt_rank = -(-cfg.d_model // 16)
    return di, m.d_state, m.d_conv, dt_rank


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    di, N, dc, R = _mamba_dims(cfg)
    pd, dev = cfg.pdtype(), gen.device
    return {
        "in_proj": _normal(gen, (d, 2 * di), pd, d ** -0.5),
        "conv_w": _normal(gen, (dc, di), pd, dc ** -0.5),
        "conv_b": torch.zeros((di,), dtype=pd, device=dev),
        "x_proj": _normal(gen, (di, R + 2 * N), pd, di ** -0.5),
        "dt_proj": _normal(gen, (R, di), pd, R ** -0.5),
        # softplus^-1(0.01)
        "dt_bias": torch.log(torch.expm1(torch.full((di,), 0.01, dtype=pd,
                                                    device=dev))),
        "A_log": torch.log(torch.arange(1, N + 1, dtype=pd, device=dev)
                           ).repeat(di, 1),
        "D": torch.ones((di,), dtype=pd, device=dev),
        "out_proj": _normal(gen, (di, d), pd, di ** -0.5),
    }


def mamba_init_state(batch: int, cfg: ModelConfig, device,
                     dtype=torch.float32) -> MambaState:
    di, N, dc, _ = _mamba_dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, dc - 1, di), dtype=dtype, device=device),
        ssm=torch.zeros((batch, di, N), dtype=torch.float32, device=device))


def _mamba_ssm_inputs(p: Params, x_conv: torch.Tensor, cfg: ModelConfig):
    """x_conv: [..., di] post-conv activations -> (dt, B_t, C_t)."""
    _, N, _, R = _mamba_dims(cfg)
    dt_ = x_conv.dtype
    # a contraction over sharded channels: its partial sums reduced before
    # dt_bias (sharded) is added
    proj = reduced(x_conv @ p["x_proj"].to(dt_))
    dt_r, B_t, C_t = torch.split(proj, [R, N, N], dim=-1)
    dt = _softplus(dt_r @ p["dt_proj"].to(dt_) + p["dt_bias"].to(dt_))
    return dt, B_t, C_t


def _mamba_step(A: torch.Tensor, D: torch.Tensor):
    """The selective-scan recurrence, in float32 whatever the activations'
    dtype."""
    def step(h, inp):
        x_t, dt_t, B_t, C_t = inp      # [B,di], [B,di], [B,N], [B,N]
        dtf = dt_t.float()
        dA = torch.exp(dtf[..., None] * A)                       # [B, di, N]
        dBx = dtf[..., None] * B_t.float()[:, None, :] * x_t.float()[..., None]
        h = dA * h + dBx
        y = (h * C_t.float()[:, None, :]).sum(-1) + D * x_t.float()
        return h, y.to(x_t.dtype)
    return step


def _mamba_consts(p: Params):
    return -torch.exp(p["A_log"].float()), p["D"].float()


def mamba_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  return_state: bool = False):
    """x: [B, T, d] -> [B, T, d] (and the final MambaState if asked)."""
    B, T, d = x.shape
    di, N, dc, _ = _mamba_dims(cfg)
    x_in, z = torch.chunk(x @ p["in_proj"].to(x.dtype), 2, dim=-1)  # [B,T,di]

    def conv(x_in, conv_w, conv_b):
        # causal depthwise conv over time, its terms added in k order
        x_pad = F.pad(x_in, (0, 0, dc - 1, 0))
        conv_w = conv_w.to(x.dtype)
        x_conv = 0
        for k in range(dc):
            x_conv = x_conv + x_pad[:, k:k + T, :] * conv_w[k]
        return x_conv + conv_b.to(x.dtype), x_pad[:, T:, :].contiguous()
    # under sharding each rank convolves its own rows and channels (`F.pad`
    # of a DTensor comes back with the wrong placements on some torch
    # versions)
    x_conv, tail = rows_and_heads(conv, x_in, (x_in, p["conv_w"], p["conv_b"]),
                                  (2, 1, 0), di, (2, 2), (0, None, None))
    x_conv = _silu(x_conv)
    dt, B_t, C_t = _mamba_ssm_inputs(p, x_conv, cfg)
    A, D = _mamba_consts(p)
    h0 = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    tm = [a.transpose(0, 1) for a in (x_conv, dt, B_t, C_t)]      # time-major
    h_final, y = _scan(_mamba_step(A, D), h0, tm, T)              # [B, T, di]
    out = (y * _silu(z)) @ p["out_proj"].to(x.dtype)
    if return_state:
        return out, MambaState(conv=tail, ssm=h_final)
    return out


def mamba_decode_step(p: Params, x_t: torch.Tensor, state: MambaState,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, MambaState]:
    """x_t: [B, d] one token -> (y_t [B, d], new state)."""
    x_in, z = torch.chunk(x_t @ p["in_proj"].to(x_t.dtype), 2, dim=-1)
    window = torch.cat([state.conv, x_in[:, None, :]], dim=1)     # [B, dc, di]
    conv_w = p["conv_w"].to(x_t.dtype)
    x_conv = (window * conv_w[None]).sum(dim=1) + p["conv_b"].to(x_t.dtype)
    x_conv = _silu(x_conv)
    dt, B_t, C_t = _mamba_ssm_inputs(p, x_conv, cfg)
    h, y = _mamba_step(*_mamba_consts(p))(state.ssm, (x_conv, dt, B_t, C_t))
    y = y * _silu(z)
    return (y @ p["out_proj"].to(x_t.dtype),
            MambaState(conv=window[:, 1:].contiguous(), ssm=h))


# ===========================================================================
# mLSTM (xLSTM matrix-memory block)
# ===========================================================================

class MLSTMState(NamedTuple):
    C: torch.Tensor   # [B, H, hd, hd]
    n: torch.Tensor   # [B, H, hd]
    m: torch.Tensor   # [B, H]


def init_mlstm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    pd, dev = cfg.pdtype(), gen.device
    std = d ** -0.5
    return {
        "wq": _normal(gen, (d, H * hd), pd, std),
        "wk": _normal(gen, (d, H * hd), pd, std),
        "wv": _normal(gen, (d, H * hd), pd, std),
        "w_i": _normal(gen, (d, H), pd, std),
        "b_i": torch.zeros((H,), dtype=pd, device=dev),
        "w_f": _normal(gen, (d, H), pd, std),
        "b_f": torch.full((H,), 3.0, dtype=pd, device=dev),  # start remembering
        "w_o": _normal(gen, (d, H * hd), pd, std),
        "out_proj": _normal(gen, (H * hd, d), pd, (H * hd) ** -0.5),
    }


def mlstm_init_state(batch: int, cfg: ModelConfig, device,
                     dtype=torch.float32) -> MLSTMState:
    return _mlstm_zero_state(batch, cfg.n_heads, cfg.head_dim, device)


def _mlstm_zero_state(batch: int, H: int, hd: int, device) -> MLSTMState:
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(C=torch.zeros((batch, H, hd, hd), **f32),
                      n=torch.zeros((batch, H, hd), **f32),
                      m=torch.full((batch, H), -1e30, **f32))


def _mlstm_gates(p: Params, x: torch.Tensor, cfg: ModelConfig):
    H, hd = cfg.n_heads, cfg.head_dim
    dt = x.dtype
    q = split_last(x @ p["wq"].to(dt), H)
    k = split_last(x @ p["wk"].to(dt), H) * hd ** -0.5
    v = split_last(x @ p["wv"].to(dt), H)
    i_log = (x @ p["w_i"].to(dt) + p["b_i"].to(dt)).float()
    # F.logsigmoid has no DTensor strategy: run it on each shard
    f_log = elementwise(F.logsigmoid,
                        (x @ p["w_f"].to(dt) + p["b_f"].to(dt)).float())
    o = torch.sigmoid(x @ p["w_o"].to(dt))
    return q, k, v, i_log, f_log, o


def _mlstm_step(carry: MLSTMState, inp):
    q, k, v, i_log, f_log = inp      # [B,H,hd] x3, [B,H] x2
    C, n, m = carry
    # the stabiliser m, as the reference writes it
    m_new = torch.maximum(f_log + m, i_log)
    i_p = torch.exp(i_log - m_new)[..., None]                     # [B,H,1]
    f_p = torch.exp(f_log + m - m_new)[..., None]
    kf, vf = k.float(), v.float()
    C = f_p[..., None] * C + i_p[..., None] * vf[..., :, None] * kf[..., None, :]
    n = f_p * n + i_p * kf
    qf = q.float()
    num = torch.einsum("bhde,bhe->bhd", C, qf)
    den = torch.clamp_min(torch.abs(torch.einsum("bhe,bhe->bh", n, qf)),
                          1.0)[..., None]
    return MLSTMState(C, n, m_new), (num / den).to(q.dtype)       # [B,H,hd]


def mlstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  return_state: bool = False):
    T = x.shape[1]
    q, k, v, i_log, f_log, o = _mlstm_gates(p, x, cfg)

    def scan(q, k, v, i_log, f_log):
        b = q.shape[0]
        carry = _mlstm_zero_state(b, q.shape[2], q.shape[3], q.device)
        tm = [a.transpose(0, 1) for a in (q, k, v, i_log, f_log)]
        final, ys = _scan(_mlstm_step, carry, tm, T)
        return (ys.reshape(b, T, -1),) + tuple(final)
    # under sharding each rank scans its own rows and heads
    ys, *final = rows_and_heads(scan, q, (q, k, v, i_log, f_log),
                                (2, 2, 2, 2, 2), cfg.n_heads, (2, 1, 1, 1))
    final = MLSTMState(*final)
    out = (ys * o) @ p["out_proj"].to(x.dtype)
    return (out, final) if return_state else out


def mlstm_decode_step(p: Params, x_t: torch.Tensor, state: MLSTMState,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, MLSTMState]:
    q, k, v, i_log, f_log, o = _mlstm_gates(p, x_t, cfg)

    def step(q, k, v, i_log, f_log, C, n, m):
        st, y = _mlstm_step(MLSTMState(C, n, m), (q, k, v, i_log, f_log))
        return (y.reshape(y.shape[0], -1),) + tuple(st)
    # under sharding each rank steps its own rows and heads
    y, *state = rows_and_heads(step, q, (q, k, v, i_log, f_log, *state),
                               (1,) * 8, cfg.n_heads, (1,) * 4)
    return (y * o) @ p["out_proj"].to(x_t.dtype), MLSTMState(*state)


# ===========================================================================
# sLSTM (xLSTM scalar-memory block with true hidden recurrence)
# ===========================================================================

class SLSTMState(NamedTuple):
    c: torch.Tensor   # [B, H, hd]
    n: torch.Tensor   # [B, H, hd]
    h: torch.Tensor   # [B, H, hd]
    m: torch.Tensor   # [B, H, hd]


_SLSTM_GATES = ("z", "i", "f", "o")


def init_slstm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    pd, dev = cfg.pdtype(), gen.device
    p: Params = {}
    for gate in _SLSTM_GATES:
        p[f"w_{gate}"] = _normal(gen, (d, H * hd), pd, d ** -0.5)
        p[f"r_{gate}"] = _normal(gen, (H, hd, hd), pd, hd ** -0.5)
        p[f"b_{gate}"] = torch.full((H * hd,), 3.0 if gate == "f" else 0.0,
                                    dtype=pd, device=dev)
    p["out_proj"] = _normal(gen, (H * hd, d), pd, (H * hd) ** -0.5)
    return p


def slstm_init_state(batch: int, cfg: ModelConfig, device,
                     dtype=torch.float32) -> SLSTMState:
    return _slstm_zero_state(batch, cfg.n_heads, cfg.head_dim, device)


def _slstm_zero_state(batch: int, H: int, hd: int, device) -> SLSTMState:
    shape = (batch, H, hd)
    f32 = dict(dtype=torch.float32, device=device)
    return SLSTMState(c=torch.zeros(shape, **f32),
                      n=torch.full(shape, 1e-6, **f32),
                      h=torch.zeros(shape, **f32),
                      m=torch.full(shape, -1e30, **f32))


def _slstm_step_fn(p: Params):
    def rec(gate: str, h_prev: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bhd,hde->bhe", h_prev,
                            p[f"r_{gate}"].to(h_prev.dtype))

    def step(state: SLSTMState, wx):   # wx: [B, H, hd] per gate, z i f o
        wz, wi, wf, wo = wx
        hp = state.h
        z = torch.tanh(wz + rec("z", hp))
        i_log = (wi + rec("i", hp)).float()
        f_log = F.logsigmoid((wf + rec("f", hp)).float())
        o = torch.sigmoid(wo + rec("o", hp))
        m_new = torch.maximum(f_log + state.m, i_log)
        i_p = torch.exp(i_log - m_new)
        f_p = torch.exp(f_log + state.m - m_new)
        c = f_p * state.c + i_p * z.float()
        n = f_p * state.n + i_p
        h = (o.float() * c / torch.clamp_min(n, 1e-6)).to(z.dtype)
        return SLSTMState(c=c, n=n, h=h.float(), m=m_new), h

    return step


def _slstm_wx(p: Params, x: torch.Tensor, cfg: ModelConfig):
    H, dt = cfg.n_heads, x.dtype
    return tuple(split_last(x @ p[f"w_{g}"].to(dt) + p[f"b_{g}"].to(dt), H)
                 for g in _SLSTM_GATES)


def slstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  return_state: bool = False):
    T = x.shape[1]
    wx = _slstm_wx(p, x, cfg)
    rs = [p[f"r_{g}"] for g in _SLSTM_GATES]

    def scan(*args):
        wx, rs = args[:4], args[4:]
        b, H, hd = wx[0].shape[0], wx[0].shape[2], wx[0].shape[3]
        carry = _slstm_zero_state(b, H, hd, wx[0].device)
        step = _slstm_step_fn(dict(zip((f"r_{g}" for g in _SLSTM_GATES),
                                       rs)))
        final, ys = _scan(step, carry, [a.transpose(0, 1) for a in wx], T)
        return (ys.reshape(b, T, -1),) + tuple(final)
    # under sharding each rank scans its own rows and heads
    y, *final = rows_and_heads(scan, wx[0], (*wx, *rs), (2,) * 4 + (0,) * 4,
                               cfg.n_heads, (2, 1, 1, 1, 1),
                               (0,) * 4 + (None,) * 4)
    final = SLSTMState(*final)
    out = (y @ p["out_proj"].to(y.dtype)).to(x.dtype)
    return (out, final) if return_state else out


def slstm_decode_step(p: Params, x_t: torch.Tensor, state: SLSTMState,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, SLSTMState]:
    wx = _slstm_wx(p, x_t, cfg)
    rs = [p[f"r_{g}"] for g in _SLSTM_GATES]

    def step(*args):
        wx, rs, st = args[:4], args[4:8], SLSTMState(*args[8:])
        st, y = _slstm_step_fn(dict(zip((f"r_{g}" for g in _SLSTM_GATES),
                                        rs)))(st, wx)
        return (y.reshape(y.shape[0], -1),) + tuple(st)
    # under sharding each rank steps its own rows and heads
    y, *state = rows_and_heads(step, wx[0], (*wx, *rs, *state),
                               (1,) * 4 + (0,) * 4 + (1,) * 4, cfg.n_heads,
                               (1,) * 5, (0,) * 4 + (None,) * 4 + (0,) * 4)
    return (y @ p["out_proj"].to(y.dtype)).to(x_t.dtype), SLSTMState(*state)
