"""Share of the traced window in which no operation ran on the device,
in the generator's cell (``device_idle_share.sat``'s reading)."""

from rag_bench import manifest


def read(run):
    return manifest.load_module("metrics", "device_idle_share.sat").read(run)
