"""The device's idle seconds whose midpoint lies inside the program's
``decode.step`` spans but outside their ``decode.replay`` and
``decode.sync`` phases (the input upload and the per-slot loop: host
work between two replays) ÷ the profiled tail's length."""


def read(obs):
    tl = obs.timeline
    if not getattr(tl, "program", ()) or tl.window_s <= 0:
        return None
    return tl.idle_in(("decode.step",),
                      outside=("decode.replay", "decode.sync")) \
        / tl.window_s
