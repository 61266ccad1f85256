"""mds_tpu_torch — the PyTorch/CUDA port of mds_tpu for one NVIDIA H100.

The JAX package `mds_tpu` is the reference this port is held against. This
package imports torch and nothing of jax or of `mds_tpu`: what it needs from
there it keeps as its own copy.

  mds_tpu_torch.models  — BiSeNetV2 and its layers (eval and train)
  mds_tpu_torch.ops     — hand-written CUDA kernels (csrc/) and their plain
                          PyTorch versions
  mds_tpu_torch.losses  — OHEM cross-entropy
  mds_tpu_torch.engine  — LR schedules, the grouped SGD, the train step
  mds_tpu_torch.deploy  — normalize→model→argmax module, HTTP server, weight
                          conversion from the JAX variables
  mds_tpu_torch.config, mds_tpu_torch.data — JSON configs, label specs
"""

from mds_tpu_torch.registry import MODELS  # noqa: F401
import mds_tpu_torch.models  # noqa: E402,F401 — populate MODELS
