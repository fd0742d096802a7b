from .types import (ConvPlan, DownPlan, LevelGeometry, UNetGeometry,
                    stencil_offsets)
from .geometry import GeometryCaps, build_unet_geometry, geometry_to_device
from .ops import (masked_batch_norm, relu, sparse_conv, sparse_down_conv,
                  sparse_up_conv, valid_mask)
from .stencil_conv import stencil_conv_fwd
from .edge_conv import down_conv_fwd, up_conv_fwd
