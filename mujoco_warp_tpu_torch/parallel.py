"""World-axis batching (mirrors `mujoco_warp_tpu/parallel/__init__.py:41`).

One card for now: the world axis is the batch axis of every Data
tensor. Splitting it across cards comes with a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from .types import Data, Model


def make_batch(m: Model, d: Data, nworld: int, qpos_noise: float = 0.0,
               generator: torch.Generator | None = None) -> Data:
  """Tile world 0 of `d` into `nworld` worlds; with qpos_noise, add
  N(0, qpos_noise^2) to qpos from `generator` (which must be given)."""
  def tile(x):
    return x[:1].expand((nworld,) + x.shape[1:]).contiguous()
  contact = d.contact.replace(**{
      f.name: tile(getattr(d.contact, f.name))
      for f in dataclasses.fields(d.contact)})
  kw = {f.name: tile(getattr(d, f.name)) for f in dataclasses.fields(d)
        if f.name != 'contact'}
  batch = d.replace(contact=contact, **kw)
  if qpos_noise:
    if generator is None:
      raise ValueError('qpos_noise needs an explicit torch.Generator')
    noise = torch.randn((nworld, m.nq), generator=generator,
                        device=generator.device, dtype=torch.float32)
    batch = batch.replace(qpos=batch.qpos + qpos_noise * noise.to(
        batch.qpos.device))
  return batch
