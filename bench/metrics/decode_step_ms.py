"""Mean host-clock time of a decode step over the host window
(``ServingEngine.decode_step_s``: input upload, graph replay and the
next tokens' copy to the host, which waits for the device)."""


def read(obs):
    steps = obs.engine.get("decode_step_s")
    if not steps:
        return None
    return 1e3 * sum(steps) / len(steps)
