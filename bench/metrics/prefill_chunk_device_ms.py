"""Mean device time of the program's own ``prefill.chunk`` spans in the
profiled tail (each span's ``device_ms``: the engine's CUDA event pair
around the chunk, read once after the tail): the in-program twin of
``prefill_chunk_ms``."""


def read(obs):
    spans = getattr(obs.timeline, "spans_named", None)
    times = [s.attrs["device_ms"] for _, _, s in spans("prefill.chunk")
             if "device_ms" in s.attrs] if spans is not None else []
    if not times:
        return None
    return sum(times) / len(times)
