"""Process start to the window's opening: imports, weights, engine,
warm-up programs (the decode graph's capture among them) and the ramp."""


def read(obs):
    return obs.setup_s
