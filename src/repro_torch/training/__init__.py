"""Training (counterpart of ``repro.training``): AdamW, the deterministic
data stream, checkpoints in the reference's layout (restorable onto a
mesh), the crash-restart loop and the int8 error-feedback all-reduce
(``compression.py``)."""

from .checkpoint import AsyncSaver, latest_step, restore, save  # noqa: F401
from .data import LMDataset  # noqa: F401
from .optimizer import AdamW, cosine_schedule  # noqa: F401
from .train_loop import TrainConfig, train  # noqa: F401
