"""95th percentile of every ``llm`` call dispatched in the window, from
dispatch to result (the core trace's ``t_dispatch`` / ``t_resolve``),
the calls still in flight at the close waited for."""

import numpy as np


def read(obs):
    calls = obs.calls_in(*obs.window)
    if not calls:
        return None
    return float(np.percentile([b - a for a, b in calls], 95))
