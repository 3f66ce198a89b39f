"""Simplified-model whole-body control layer, batch-first.

PyTorch counterpart of `cmw_tpu/wbc/`: swing-foot SE3 interpolation
(`swing_foot`), ZMP computation, measured and desired (`zmp`), the CoM-ZMP
stabilizer (`com_zmp`) and the QP-based differential inverse kinematics
with the task set of ik.ini (`diff_ik`).
"""
