"""Plain PyTorch reference of one MPC tick, for the benchmark's check.

A frozen copy of the main path of the PyTorch port (rigid-body algorithms,
formulations, transcription, the SQP and its ADMM QP, the MPC tick), with
every hand-written kernel replaced by its plain PyTorch version: the
block Cholesky recursion for the node and whole-horizon factorizations,
and the masked-einsum RNEA derivative pass. It imports nothing of the
program, so a later change to the program cannot move it. Run it with
TF32 off (``tick(..., allow_tf32=False)``), as the program's solve is.
"""
