"""The device's idle seconds whose midpoint lies inside the program's
``prefill.forward`` spans (the eager forward's launches) ÷ the profiled
tail's length."""


def read(obs):
    tl = obs.timeline
    if not getattr(tl, "program", ()) or tl.window_s <= 0:
        return None
    return tl.idle_in(("prefill.forward",)) / tl.window_s
