"""MANN mixture-of-experts trajectory generation, in PyTorch.

Counterpart of `cmw_tpu.mann`: the mixture-of-experts network (the benchmark
hands it weights made in memory; the ONNX loader is not in this copy), the
autoregressive rollout with Schmitt-trigger contact extraction, and the
ellipsoid-limited joystick input builder, batch-first on [B, ...] tensors.
"""

from portbench.reference.mann import generator, input_builder, network

__all__ = ["generator", "input_builder", "network"]
