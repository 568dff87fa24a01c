"""Hand-written CUDA kernels of the port, one wrapper per TPU kernel:

  smooth   B1  csrc/smooth.cu   (pallas/smooth_kernels.smooth_mega_batched)
  contact  B2  csrc/contact.cu  (pallas/contact_kernels.contact_efc)
  glue     B3  csrc/glue.cu     (pallas/solver_kernels.make_glue_kernel)
  newton   B4  csrc/newton.cu   (pallas/solver_kernels.newton_solve_batched)
  batch_linalg.spd_solve   B5  csrc/batch_linalg.cu
                               (pallas/batch_linalg.spd_solve_batched)
  batch_linalg.cho_solve   B6  (pallas/batch_linalg.cho_solve_batched)
  batch_linalg.tree_ldl    B7  (pallas/batch_linalg.tree_ldl_solve_batched)
  batch_linalg.tree_solve  B8
                      (pallas/batch_linalg.tree_solve_from_factor_batched)
  smooth.smooth_front      B9   csrc/smooth.cu
                               (pallas/smooth_kernels.smooth_front_batched)
  smooth.kinematics        B10  (pallas/smooth_kernels.kinematics_batched)
  smooth.com_pos           B11  (pallas/smooth_kernels.com_pos_batched)
  smooth.crb               B12  (pallas/smooth_kernels.crb_batched)

B2 runs one warp per world (each of its entries: the pyramidal and the
elliptic rows, each also with the joint-equality and plane-box branches,
`eqbox_`, or with those and the capsule-box and box-box branches,
`box_`), and so do B5-B8. B3, B4, B3e and B4-elliptic share the solve's
device code, csrc/newton.cuh (one warp per world, with the elliptic cone
for B3e and B4-elliptic); B9-B12 are instantiations of B1's kernel that
run some of its stages.

Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors, counting launches in its module's
`launches` (batch_linalg: one count per kernel, and B7's launches
without the factor again in `launches_no_factor`; glue and newton count the
elliptic entries in `launches_ell`, smooth B9-B12 in `launches_front`,
`launches_kin`, `launches_com` and `launches_crb`).
"""
