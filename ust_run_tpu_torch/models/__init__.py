from ust_run_tpu_torch.models.deeplab import DeepLabV2  # noqa: F401
from ust_run_tpu_torch.models.dsbn import DomainSpecificBatchNorm2d  # noqa
from ust_run_tpu_torch.models.layers import GroupedBatchNorm  # noqa: F401
from ust_run_tpu_torch.models.resnet import ResNet  # noqa: F401
from ust_run_tpu_torch.models.transunet import TransUNet  # noqa: F401
from ust_run_tpu_torch.models.unet import UNet  # noqa: F401
from ust_run_tpu_torch.models.unet2d import (  # noqa: F401
    Decoder, Discriminator, Encoder, RecDecoder, Unet2D, Unet2D_DS,
    Unet2D_MS, Unet2D_MT)
from ust_run_tpu_torch.models.wrn import WideResNet, build_WideResNet  # noqa
