"""Time the tensor operations MPR's support calls are made of, at P17's
sizes (8192 worlds, the 96 pairs a culled group keeps, 64 hull vertices,
1 or 4 portals: the base and the tilted ones), on the card.

    python3 mujoco_warp_tpu_torch/utils/mpr_ops.py

Prints the card's time per call (CUDA events, 5 calls) of: R^T v of
(3, 3) frames as a broadcast batched matmul and as products and sums
(`collision_convex._mtv`); each hull vertex's dot with a direction as a
batched matrix product of the hull (xyz, bias) with (d, 1), and as three
multiply-adds over the hull's planes (`collision_convex._supp_mesh`),
each then with its argmax. Needs a card.
"""

import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
W, P, V = 8192, 96, 64


def _ms(fn, reps: int = 5) -> float:
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def main() -> int:
  sys.path.insert(0, HERE)
  from mujoco_warp_tpu_torch.bench import card
  dev = 'cuda'
  gen = torch.Generator(device=dev).manual_seed(0)
  rand = lambda *s: torch.randn(s, device=dev, generator=gen)
  R = rand(W, P, 3, 3)
  hull = rand(W, P, V, 4)
  planes = hull.movedim(-1, 0).contiguous()
  print(f'({card()}) worlds {W}, pairs {P}, hull vertices {V}')
  for T in (1, 4):
    v = rand(T, W, P, 3)
    d = rand(T, W, P, 3)
    xt = torch.cat([d, torch.ones_like(d[..., :1])], -1).reshape(
        T, W, P, 4).movedim(0, -1).contiguous()
    planar = lambda: torch.addcmul(torch.addcmul(torch.addcmul(
        planes[3], planes[0], d[..., 0, None]), planes[1], d[..., 1, None]),
        planes[2], d[..., 2, None])
    rows = {
        'R^T v, broadcast matmul': lambda: (v[..., None, :] @ R)[..., 0, :],
        'R^T v, products and sums': lambda: (R * v[..., :, None]).sum(-2),
        'hull dots, batched product': lambda: hull @ xt,
        'hull dots, batched product + argmax':
            lambda: torch.argmax(hull @ xt, -2),
        'hull dots, planar multiply-adds': planar,
        'hull dots, planar multiply-adds + argmax':
            lambda: torch.argmax(planar(), -1),
    }
    for name, fn in rows.items():
      print(f'  {T} portal(s): {name:42s} {_ms(fn):8.4f} ms', flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
