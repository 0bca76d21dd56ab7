"""apex_tpu_torch.rnn — RNNReLU, RNNTanh, LSTM, GRU and mLSTM, stacked
and bidirectional (counterpart of apex_tpu/rnn.py, the reference's
`apex.RNN`).

The cells' math and parameters are the JAX package's: per layer and
direction a dict with `w_ih` (in, G·H), `w_hh` (H, G·H), `b_ih`, `b_hh`
(G: 1, 4 for LSTM and mLSTM, 3 for GRU), mLSTM adding `w_mx` and
`w_mh`; `params_from_jax` carries the JAX package's parameters across.
The products run in the input's dtype; the recurrent state (h, and c)
stays in fp32, as in the JAX package.  The time loop is a Python loop of
matmuls (cuBLAS on the card; the JAX package leaves its `lax.scan` to
XLA, with no Pallas kernel), with each layer's input products for the
whole sequence as one GEMM before the loop.

The JAX package sizes mLSTM's `w_mx` by the position in its parameter
list rather than by the layer's input, so a bidirectional mLSTM with
input_size != hidden_size, or with more than one layer, has a `w_mx`
that does not fit its input and fails there.  The port keeps those
parameter shapes, so that `params_from_jax` maps one to one, and raises
a ValueError for those configurations when the model is built.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from apex_tpu_torch.ops._common import resolve_device


def _linear_init(key, shape, dtype, device):
    bound = 1.0 / math.sqrt(shape[0])
    w = torch.rand(shape, generator=key) * (2 * bound) - bound
    return w.to(dtype=dtype, device=device)


def params_from_jax(params, device=None, dtype=None):
    """The JAX package's parameter list (dicts of arrays) as this
    module's: the same names and shapes, on `device` (the card unless
    the caller asks for another), cast to `dtype` when given."""
    dev = resolve_device(device)
    out = []
    for p in params:
        d = {}
        for k, v in p.items():
            t = torch.from_numpy(np.array(v, dtype=np.float32))
            d[k] = t.to(device=dev, dtype=dtype or torch.float32)
        out.append(d)
    return out


class _RNNBase:
    """init / apply over a cell, stacked and bidirectional."""

    gate_mult = 1

    def __init__(self, input_size, hidden_size, num_layers=1,
                 bidirectional=False):
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional

    @property
    def n_dir(self):
        return 2 if self.bidirectional else 1

    def init(self, key: torch.Generator, dtype=torch.float32, device=None):
        """Per layer and direction: w_ih, w_hh uniform in ±1/√fan-in
        (drawn from the CPU generator `key`), zero biases, on `device`
        (the card unless the caller asks for another)."""
        device = resolve_device(device)
        params = []
        g = self.gate_mult * self.hidden_size
        for layer in range(self.num_layers):
            in_dim = self.input_size if layer == 0 \
                else self.hidden_size * self.n_dir
            for _ in range(self.n_dir):
                params.append({
                    "w_ih": _linear_init(key, (in_dim, g), dtype, device),
                    "w_hh": _linear_init(key, (self.hidden_size, g), dtype,
                                         device),
                    "b_ih": torch.zeros((g,), dtype=dtype, device=device),
                    "b_hh": torch.zeros((g,), dtype=dtype, device=device),
                })
        return params

    def _init_state(self, x):
        return torch.zeros((x.shape[1], self.hidden_size),
                           dtype=torch.float32, device=x.device)

    def _inputs(self, p, xs):
        """What each step needs of its input, for the whole sequence."""
        s, b, _ = xs.shape
        return ((xs.reshape(s * b, -1) @ p["w_ih"] + p["b_ih"])
                .reshape(s, b, -1),)

    def _cell(self, p, xin, state, dtype):
        raise NotImplementedError

    def _run_dir(self, p, xs, reverse=False):
        ins = self._inputs(p, xs)
        state = self._init_state(xs)
        outs = [None] * xs.shape[0]
        steps = range(xs.shape[0] - 1, -1, -1) if reverse \
            else range(xs.shape[0])
        for t in steps:
            state, outs[t] = self._cell(p, [a[t] for a in ins], state,
                                        xs.dtype)
        return torch.stack(outs)

    def apply(self, params, x):
        """x: (S, B, input_size) -> (S, B, H * n_dir)."""
        h = x
        for layer in range(self.num_layers):
            outs = [self._run_dir(params[layer * self.n_dir + d], h,
                                  reverse=(d == 1))
                    for d in range(self.n_dir)]
            h = torch.cat(outs, dim=-1) if self.n_dir == 2 else outs[0]
        return h


class RNNReLU(_RNNBase):
    """h' = relu(x W_ih + b_ih + h W_hh + b_hh)."""

    def _cell(self, p, xin, h, dtype):
        g = xin[0] + h.to(dtype) @ p["w_hh"] + p["b_hh"]
        h_new = torch.clamp_min(g.float(), 0)
        return h_new, h_new.to(dtype)


class RNNTanh(_RNNBase):
    """h' = tanh(x W_ih + b_ih + h W_hh + b_hh)."""

    def _cell(self, p, xin, h, dtype):
        g = xin[0] + h.to(dtype) @ p["w_hh"] + p["b_hh"]
        h_new = torch.tanh(g.float())
        return h_new, h_new.to(dtype)


def _lstm_update(g, c):
    i, f, gg, o = torch.chunk(g, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


class LSTM(_RNNBase):
    """Gates i, f, g, o from x W_ih + b_ih + h W_hh + b_hh; fp32 c."""

    gate_mult = 4

    def _init_state(self, x):
        z = super()._init_state(x)
        return (z, z)

    def _cell(self, p, xin, state, dtype):
        h, c = state
        g = (xin[0] + h.to(dtype) @ p["w_hh"] + p["b_hh"]).float()
        h_new, c_new = _lstm_update(g, c)
        return (h_new, c_new), h_new.to(dtype)


class GRU(_RNNBase):
    """r, z, n gates; n = tanh(x W_in + b_in + r (h W_hn + b_hn))."""

    gate_mult = 3

    def _cell(self, p, xin, h, dtype):
        gi = xin[0].float()
        gh = (h.to(dtype) @ p["w_hh"] + p["b_hh"]).float()
        ir, iz, in_ = torch.chunk(gi, 3, dim=-1)
        hr, hz, hn = torch.chunk(gh, 3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(in_ + r * hn)
        h_new = (1 - z) * n + z * h
        return h_new, h_new.to(dtype)


class mLSTM(_RNNBase):
    """Multiplicative LSTM: m = (x W_mx) * (h W_mh) takes h's place in
    the gates' product (x W_ih + b_ih + m W_hh + b_hh)."""

    gate_mult = 4

    def __init__(self, input_size, hidden_size, num_layers=1,
                 bidirectional=False):
        if bidirectional and (input_size != hidden_size or num_layers > 1):
            raise ValueError(
                f"mLSTM(input_size={input_size}, hidden_size={hidden_size},"
                f" num_layers={num_layers}, bidirectional=True): the JAX "
                f"package's w_mx shapes, which this module keeps, fit a "
                f"bidirectional mLSTM only with one layer and input_size "
                f"== hidden_size")
        super().__init__(input_size, hidden_size, num_layers, bidirectional)

    def init(self, key: torch.Generator, dtype=torch.float32, device=None):
        device = resolve_device(device)
        params = super().init(key, dtype, device)
        h = self.hidden_size
        for idx, p in enumerate(params):
            # the JAX package's rule: by the position in the list
            in_dim = self.input_size if idx == 0 else h
            p["w_mx"] = _linear_init(key, (in_dim, h), dtype, device)
            p["w_mh"] = _linear_init(key, (h, h), dtype, device)
        return params

    def _init_state(self, x):
        z = super()._init_state(x)
        return (z, z)

    def _inputs(self, p, xs):
        s, b, _ = xs.shape
        flat = xs.reshape(s * b, -1)
        return ((flat @ p["w_ih"] + p["b_ih"]).reshape(s, b, -1),
                (flat @ p["w_mx"]).reshape(s, b, -1))

    def _cell(self, p, xin, state, dtype):
        h, c = state
        m = xin[1] * (h.to(dtype) @ p["w_mh"])
        g = (xin[0] + m @ p["w_hh"] + p["b_hh"]).float()
        h_new, c_new = _lstm_update(g, c)
        return (h_new, c_new), h_new.to(dtype)
