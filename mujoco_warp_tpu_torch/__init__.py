"""mujoco_warp_tpu_torch: the PyTorch/CUDA port of mujoco_warp_tpu.

Batched MuJoCo physics on an NVIDIA H100. The JAX package beside it is
the reference; this package imports neither JAX nor it. Entry points run
on the card unless the caller passes device='cpu'.
"""

import torch

from .forward import step_batched
from .io import (data_from_numpy, efc_layout, load_model, make_data,
                 model_from_numpy, put_model, save_model)
from .parallel import make_batch
from .types import Contact, Data, Model, Option, Statistic

# float32 everywhere: no TF32 in matrix products or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
