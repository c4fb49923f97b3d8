from sofima_tpu_torch.processor.base import (OutputNums, SubvolumeProcessor,
                                             SuggestedXyz)
from sofima_tpu_torch.processor.runner import process_volume
