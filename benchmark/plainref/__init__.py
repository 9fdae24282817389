"""The benchmark's plain reference: a frozen copy of the plain PyTorch
paths of ``mcptam_tpu_torch`` (tracking front-end, tracker, map state,
bundle adjustment) and of its synthetic generators, with every kernel
wrapper reduced to its plain version.  It imports nothing of the program,
so a later change to the program cannot move the yardstick.

Float32 matrix products run in full float32: TF32 is switched off here, as
the program switches it off.  The precision control switches it on.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
