"""Programs completed per second of the window, counted in programs'
worth of calls: each program's ``llm`` calls that resolved inside the
window, as a share of all the calls that program made, summed over the
programs and divided by the window's seconds (host clock).  Every program
of a mix makes the same number of calls, so this is the programs
completed in the window plus the finished share of those the window's
edges cut, and it does not step by whole programs."""


def read(obs):
    a, b = obs.window
    done = sum(sum(a <= t1 <= b for _, t1 in p.llm) / len(p.llm)
               for p in obs.programs if p.ok and p.llm)
    return done / (b - a)
