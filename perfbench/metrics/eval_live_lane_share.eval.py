"""The share of an eval job's lane-steps taken on lanes whose game had not
ended, in %: the program's counts `eval.live_lane_steps` over
`eval.lane_steps` (the lanes times the steps each job stepped), summed
over the window's jobs (`perfbench/program_trace.py`).  The rest is work
spent stepping finished lanes."""
from perfbench import program_trace

HOOKS = []


def read(run):
    lanes = program_trace.count(run, "eval.lane_steps")
    if not lanes:
        return None
    return 100.0 * program_trace.count(run, "eval.live_lane_steps") / lanes
