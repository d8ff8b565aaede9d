"""The window's wall time over every rollout step it completed, from
back-to-back rollouts of the cell's length; the window ends on a
synchronise."""

UNIT = "ms/step"
BETTER = "lower"
SOURCE = "host_clock"


def read(record, setup_s):
    if record["kind"] != "apply" or not record["units"]:
        return None
    return 1e3 * record["wall_s"] / record["units"]
