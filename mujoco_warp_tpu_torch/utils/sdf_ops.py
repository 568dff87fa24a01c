"""Time the ways to read a voxel grid's 8 cell corners at P18's sizes.

    python3 mujoco_warp_tpu_torch/utils/sdf_ops.py

`collision_sdf.grid_sdf` reads, for each sample, the 8 corners of its
cell in aloha_sdf's committed grids. This script times each way of that
read on the card, for 2^24 samples (one chunk, `SDF_ELEMENTS`): from a
table of each cell's corners (G (R - 1)^3 rows of 8 float32) rows by
advanced indexing `cells[i]`, `index_select` with int64 and int32
indices, `gather` along the rows with the index expanded over the 8
corners, `embedding`; and `take` of the 8 values from the flat grids
themselves (what `grid_sdf` does); the samples' cells drawn the way a
chunk draws them (15
step sizes of a descent in neighbouring cells, a chunk's descents over
6 grids) and at random over every grid. Prints each way's ms per chunk
(CUDA events, 5 calls after one) and checks that they read the same
values. Needs a card.
"""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
  sys.path.insert(0, HERE)
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import collision_sdf, models
  from mujoco_warp_tpu_torch.bench import card
  m = mt.load_model(models.ALOHA_SDF_NPZ, device='cuda')
  grids = m.sdf_grids
  G, R = grids.shape[:2]
  c = R - 1
  # the corner table: each cell's 8 corners in a row, corner j at offset
  # (j & 1, j >> 1 & 1, j >> 2 & 1)
  cells = torch.stack([grids[:, (j & 1):(j & 1) + c,
                             (j >> 1 & 1):(j >> 1 & 1) + c,
                             (j >> 2 & 1):(j >> 2 & 1) + c]
                       for j in range(8)], -1).reshape(G * c ** 3, 8)
  n = collision_sdf.SDF_ELEMENTS
  gen = torch.Generator(device='cuda').manual_seed(0)

  def draw(local: bool):
    """(cell row, its (g, x, y, z)) of n samples."""
    if local:
      d = n // 15
      g = torch.randint(0, 6, (d,), device='cuda', generator=gen)
      xyz = torch.randint(0, c - 1, (d, 3), device='cuda', generator=gen)
      g = g.repeat_interleave(15)
      xyz = xyz.repeat_interleave(15, 0) + torch.randint(
          0, 2, (d * 15, 3), device='cuda', generator=gen)
    else:
      g = torch.randint(0, G, (n,), device='cuda', generator=gen)
      xyz = torch.randint(0, c, (n, 3), device='cuda', generator=gen)
    row = ((g * c + xyz[:, 0]) * c + xyz[:, 1]) * c + xyz[:, 2]
    return row, g, xyz

  def ms(fn):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
      fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / 5

  flat = grids.reshape(-1)
  offs = torch.tensor([(j & 1) * R * R + (j >> 1 & 1) * R + (j >> 2 & 1)
                       for j in range(8)], device='cuda')
  print(f'corner table {tuple(cells.shape)} ({cells.numel() * 4 / 1e6:.1f}'
        f' MB), {n} samples a chunk ({card()})')
  for local in (True, False):
    row, g, xyz = draw(local)
    row32 = row.int()
    base = ((g * R + xyz[:, 0]) * R + xyz[:, 1]) * R + xyz[:, 2]
    idx8 = base[:, None] + offs
    ways = {
        'cells[i]': lambda: cells[row],
        'index_select int64': lambda: torch.index_select(cells, 0, row),
        'index_select int32': lambda: torch.index_select(cells, 0, row32),
        'gather expanded': lambda: torch.gather(
            cells, 0, row[:, None].expand(-1, 8)),
        'embedding': lambda: torch.nn.functional.embedding(row, cells),
        'take x8 (grids)': lambda: torch.take(flat, idx8),
    }
    ref = ways['cells[i]']()
    for name, fn in ways.items():
      same = bool(torch.equal(fn(), ref))
      print(f'  {"a chunk" if local else "at random":9s} {name:20s} '
            f'{ms(fn):8.3f} ms  same values: {same}', flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
