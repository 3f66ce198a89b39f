"""MANN mixture-of-experts forward pass in PyTorch.

Counterpart of `cmw_tpu/mann/network.py`, the same network as the ONNX
graphs onnx_50_mann*.onnx:

  h   = W_in  @ x + b_in                      # input normalization (124)
  g   = elu(Wg0 h + bg0); g = elu(Wg1 g + bg1)
  w   = softmax(Wg2 g + bg2)                  # 4 expert weights
  z   = elu(sum_e w_e (Wk[e] z + bk[e]))      # 3 expert layers, the last linear
  y   = W_out @ z + b_out                     # denormalization (91)

Each expert layer is linear in the blend weights, so all experts are applied
with one product against the stacked [E * out, in] weights and their outputs
blended after: no blended [B, out, in] matrix per item. Plain matmuls; the
JAX package computes these products outside any Pallas kernel too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as Fn



class MANNWeights(NamedTuple):
    w_in: torch.Tensor  # [124, 124]
    b_in: torch.Tensor  # [124]
    gate_w: tuple  # ([32,124],[32,32],[4,32])
    gate_b: tuple  # ([32],[32],[4])
    expert_w: tuple  # ([4,128,124],[4,128,128],[4,91,128])
    expert_b: tuple  # ([4,128],[4,128],[4,91])
    w_out: torch.Tensor  # [91, 91]
    b_out: torch.Tensor  # [91]

    @property
    def in_size(self):
        return self.w_in.shape[1]

    @property
    def out_size(self):
        return self.w_out.shape[0]


def mann_forward(w: MANNWeights, x):
    """x [..., 124] -> y [..., 91]. Gating + blended-expert MLP."""
    h = Fn.linear(x, w.w_in, w.b_in)
    g = Fn.elu(Fn.linear(h, w.gate_w[0], w.gate_b[0]))
    g = Fn.elu(Fn.linear(g, w.gate_w[1], w.gate_b[1]))
    om = torch.softmax(Fn.linear(g, w.gate_w[2], w.gate_b[2]), dim=-1)  # [..., E]

    z = h
    for layer, (We, be) in enumerate(zip(w.expert_w, w.expert_b)):
        E, o, i = We.shape
        # every expert at once: [..., E * o] -> [..., E, o], then the blend
        # sum_e om_e (We[e] z + be[e])
        ze = Fn.linear(z, We.reshape(E * o, i)).unflatten(-1, (E, o))
        z = torch.einsum("...e,...eo->...o", om, ze) + om @ be
        if layer < 2:
            z = Fn.elu(z)
    return Fn.linear(z, w.w_out, w.b_out)


class MANN(nn.Module):
    """Inference module: holds a MANNWeights as buffers (so `.to()` moves
    them) and runs `mann_forward`."""

    def __init__(self, weights: MANNWeights):
        super().__init__()
        for name, value in weights._asdict().items():
            if isinstance(value, tuple):
                for k, t in enumerate(value):
                    self.register_buffer(f"{name}_{k}", t)
            else:
                self.register_buffer(name, value)
        self._layout = {name: len(v) if isinstance(v, tuple) else None for name, v in weights._asdict().items()}

    @property
    def weights(self) -> MANNWeights:
        return MANNWeights(**{
            name: getattr(self, name) if n is None else tuple(getattr(self, f"{name}_{k}") for k in range(n))
            for name, n in self._layout.items()
        })

    def forward(self, x):
        return mann_forward(self.weights, x)
