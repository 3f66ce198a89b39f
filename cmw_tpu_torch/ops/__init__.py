"""Hand-written Hopper kernels of the solve, one module each.

  spd_inverse  batched SPD inverse (csrc/spd_inverse.cu), replaces the
               Pallas `spd_inverse_pallas`
  symv         packed symmetric matvec (csrc/symv.cu), replaces the Pallas
               `symv_packed`
  admm_fused   all ADMM iterations of one SQP step (csrc/admm_fused.cu),
               replaces the Pallas `admm_fused_pallas`
  riccati_admm all ADMM iterations of one SQP step on the Riccati path
               (csrc/riccati_admm.cu); replaces no Pallas kernel (JAX runs
               that loop as XLA)
  rigid_step   every substep of the rigid plant's control tick
               (csrc/rigid_step.cu); replaces no Pallas kernel (JAX runs the
               substeps as XLA)
  _build       nvcc build of csrc/*.cu and the ctypes binding

Each wrapper launches its kernel on a CUDA tensor (or raises), uses its plain
PyTorch twin on a CPU tensor, and counts its launches in a module-level
`launches` integer. `rigid_step` alone takes no CPU tensor: its twin,
`sim/rigid_body._dynamics_step`, is run by its caller on the CPU.
"""
