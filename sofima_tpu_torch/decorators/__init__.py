from sofima_tpu_torch.decorators.base import (Decorator, Filter, build,
                                              register, registered)
from sofima_tpu_torch.decorators import affine, flow, maps, warp  # registers
