"""The benchmark's plain reference: a frozen copy of the program's eager code.

Taken from `cmw_tpu_torch` when the benchmark was defined, with its imports
renamed to this package, cut to what the cells run, and with one part
replaced:

  runtime/cache.py  every `graphed` call runs eagerly: no CUDA graph.

Left out: the dense KKT branch of the solve with its three hand-written
kernels (`ops/`: inverse, packed symv, fused ADMM), which no preset runs,
and the ONNX loader (the benchmark makes its weights in memory). A cell
that runs them brings their plain copies with it.

It imports nothing of the program and is never edited with it: a later
change to the program is held against what the program computed here.
`portbench/reference/models/ergocub.urdf` is a copy of the program's URDF.
"""

import torch as _torch

__version__ = "0.1.0"

# Control numerics: TF32 keeps ~3 decimal digits, far too coarse for the
# KKT solve (a reduced-precision KKT operator moved the ADMM fixed point in
# the reference). Keep every float32 product in full float32 on the card.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

# Captured dispatch (runtime/cache.py): for batched LU (the IK's 47-row KKT
# solve and inverse at B > 1) PyTorch's default picks MAGMA, whose batched
# factorisation cannot be captured in a CUDA graph; cuSOLVER / cuBLAS's can,
# and the eager calls take the same route so that a replay equals them.
if _torch.backends.cuda.is_built():
    _torch.backends.cuda.preferred_linalg_library("cusolver")
