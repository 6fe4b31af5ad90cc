from ust_run_tpu_torch.models.layers import GroupedBatchNorm  # noqa: F401
from ust_run_tpu_torch.models.unet import UNet  # noqa: F401
