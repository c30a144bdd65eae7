"""Mean ``llm`` calls in flight per program: the sum of a program's call
durations (the core trace's ``t_dispatch`` / ``t_resolve``) ÷ its wall
time, averaged over the programs completed in the host window."""


def read(obs):
    done = obs.programs_done_in(*obs.host_window)
    if not done:
        return None
    return sum(sum(b - a for a, b in p.llm) / (p.t_end - p.t_start)
               for p in done) / len(done)
