"""Launchers (counterpart of ``repro.launch``): the train step and state
(:mod:`.steps`), the training CLI (``python -m repro_torch.launch.train``)
and the serving CLI (``python -m repro_torch.launch.serve``, a routed
replica fleet).  The reference's mesh helpers and dry-run wait for
ROADMAP §A.11 and §A.12."""

from .steps import init_train_state, make_train_step  # noqa: F401
