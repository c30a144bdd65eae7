"""Launchers (counterpart of ``repro.launch``): the train step and state
(:mod:`.steps`) and the training CLI (``python -m repro_torch.launch.train``).
The reference's mesh helpers, serving launcher and dry-run wait for
ROADMAP §A.11 and §A.12."""

from .steps import init_train_state, make_train_step  # noqa: F401
