from sofima_tpu_torch.utils.bounding_box import BoundingBox
from sofima_tpu_torch.utils.box_generator import BoxGenerator
from sofima_tpu_torch.utils.subvolume import Subvolume
