from strutopy_tpu_torch.models.config import STMConfig
from strutopy_tpu_torch.models.state import STMState
from strutopy_tpu_torch.models.stm import STM

__all__ = ["STMConfig", "STMState", "STM"]
