"""Mean active slots per decode step over the host window
(``ServingEngine.batch_occupancy``)."""


def read(obs):
    occ = obs.engine.get("occupancy")
    if not occ:
        return None
    return sum(occ) / len(occ)
