"""The window's wall time over the training iterations it completed, each
ending when its loss has been read back; the window ends on a
synchronise."""

UNIT = "ms/iter"
BETTER = "lower"
SOURCE = "host_clock"


def read(record, setup_s):
    if record["kind"] != "train" or not record["units"]:
        return None
    return 1e3 * record["wall_s"] / record["units"]
