"""Hand-written CUDA kernels of the port, one module per TPU kernel:

  smooth   B1  csrc/smooth.cu   (pallas/smooth_kernels.smooth_mega_batched)
  contact  B2  csrc/contact.cu  (pallas/contact_kernels.contact_efc)
  glue     B3  csrc/glue.cu     (pallas/solver_kernels.make_glue_kernel)

Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors, counting launches in its module's
`launches`.
"""
