from .sparse_unet import ARCHS, MinkUNet
from .disnet import build_disnet, output_dim
from .resnet import RESNET_ARCHS, ResNet
