"""MANN mixture-of-experts trajectory generation, in PyTorch.

Counterpart of `cmw_tpu.mann`: the mixture-of-experts network (weights read
straight from the ONNX files by the port's own `onnx_import`), the
autoregressive rollout with Schmitt-trigger contact extraction, and the
ellipsoid-limited joystick input builder, batch-first on [B, ...] tensors.
"""

from cmw_tpu_torch.mann import generator, input_builder, network, onnx_import

__all__ = ["generator", "input_builder", "network", "onnx_import"]
