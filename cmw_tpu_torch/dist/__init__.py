"""Distribution layer: batched scenario sweeps (PyTorch counterpart of
`cmw_tpu/dist/`). The scaling axis is the batch: one card runs the scenarios
as one batch in chunks; with `use_mesh` each rank of a `torch.distributed`
process group runs its slice and the metrics are reduced across the group.
"""
