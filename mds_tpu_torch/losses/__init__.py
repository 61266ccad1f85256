"""Losses of the port; the library losses and the contrast, cross-dataset
and OHEM losses exported as mds_tpu/losses/__init__.py exports JAX's."""

from mds_tpu_torch.losses.ohem_ce import (  # noqa: F401
    MdsOhemCELoss,
    MdsOhemNLLPlusLoss,
    OhemCELoss,
    cross_entropy_per_pixel,
)
from mds_tpu_torch.losses.helpers import (  # noqa: F401
    adj_nll_plus_loss,
    circle_loss,
    focal_loss,
    multi_label_cross_entropy,
    nll_plus_loss,
    recall_cross_entropy,
    weighted_nll_plus_loss,
)
from mds_tpu_torch.losses.lovasz import (  # noqa: F401
    boundary_aware_focal_loss,
    lovasz_softmax,
)
from mds_tpu_torch.losses.rmi import rmi_loss  # noqa: F401
from mds_tpu_torch.losses.aaf import AAFLoss  # noqa: F401
from mds_tpu_torch.losses.contrast import (  # noqa: F401
    MemoryBank,
    PixelContrastLoss,
    memory_bank_push,
)
from mds_tpu_torch.losses.cross_datasets import CrossDatasetsCELossAdvGNN  # noqa: F401
