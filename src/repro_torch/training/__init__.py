"""Training (counterpart of ``repro.training``): AdamW, the deterministic
data stream, checkpoints in the reference's layout and the crash-restart
loop.  The int8 error-feedback all-reduce (``compression.py``) comes with
the multi-process work (ROADMAP §A.11)."""

from .checkpoint import AsyncSaver, latest_step, restore, save  # noqa: F401
from .data import LMDataset  # noqa: F401
from .optimizer import AdamW, cosine_schedule  # noqa: F401
from .train_loop import TrainConfig, train  # noqa: F401
