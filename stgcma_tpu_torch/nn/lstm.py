"""A torch-compatible LSTM with the JAX package's rounding points.

Port of `stgcma_tpu/nn/lstm.py` (:1-67): torch's gate order [i, f, g, o],
seq-first input, the weights in torch's packed layout (w_ih (4H, in), w_hh
(4H, H)). Each step computes the gate sums as `_cell_scan` (:33-52) does,
xt W_ih^T + h W_hh^T + (b_ih + b_hh) with every term in the input's dtype,
so a bf16 LSTM rounds where the JAX one does; `nn.LSTM` and cuDNN round
elsewhere. The input products of all steps are one matmul (each step's row
is the same product). Reference call site: the AVQA question encoder
(AVQA/model/Swin_AVQAModel_V1.py:37-59).
"""
from __future__ import annotations

import torch
from torch import nn


class LSTMLayer(nn.Module):
    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.zeros(4 * hidden_size, input_size))
        self.w_hh = nn.Parameter(torch.zeros(4 * hidden_size, hidden_size))
        self.b_ih = nn.Parameter(torch.zeros(4 * hidden_size))
        self.b_hh = nn.Parameter(torch.zeros(4 * hidden_size))


class LSTM(nn.Module):
    """`num_layers` stacked layers under the JAX tree's keys (`layers.{l}`)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1):
        super().__init__()
        self.layers = nn.ModuleList(LSTMLayer(input_size if l == 0 else hidden_size, hidden_size)
                                    for l in range(num_layers))


def _cell_loop(p: LSTMLayer, x: torch.Tensor):
    """x: (T, B, in) -> outputs (T, B, H), (h_T, c_T), from zero states."""
    T, B, _ = x.shape
    H = p.w_hh.shape[1]
    dt = x.dtype
    xw = torch.matmul(x, p.w_ih.to(dt).t())              # (T, B, 4H), each row rounded
    w_hh = p.w_hh.to(dt).t()
    b = (p.b_ih + p.b_hh).to(dt)
    h = torch.zeros(B, H, dtype=dt, device=x.device)
    c = torch.zeros(B, H, dtype=dt, device=x.device)
    ys = []
    for t in range(T):
        gates = xw[t] + torch.matmul(h, w_hh) + b
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H:2 * H])
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys), (h, c)


def lstm_apply(lstm: LSTM, x: torch.Tensor):
    """x: (T, B, input_size), seq-first. Returns (outputs (T, B, H), (h_n,
    c_n)) with h_n / c_n (num_layers, B, H), as torch's nn.LSTM does."""
    hs, cs = [], []
    y = x
    for p in lstm.layers:
        y, (h, c) = _cell_loop(p, y)
        hs.append(h)
        cs.append(c)
    return y, (torch.stack(hs), torch.stack(cs))
