"""The port's model zoo; importing it fills mds_tpu_torch.MODELS."""

from mds_tpu_torch.models import bisenetv1, bisenetv2  # noqa: F401
