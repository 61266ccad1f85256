"""The port's model zoo; importing it fills mds_tpu_torch.MODELS."""

from mds_tpu_torch.models import (  # noqa: F401
    bisenetv1,
    bisenetv2,
    bisenetv2_contrast,
    gnn,
    hrnet,
    semseg,
    swin,
)
