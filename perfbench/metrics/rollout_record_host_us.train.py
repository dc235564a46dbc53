"""Host microseconds a rollout step spends in the program's
`ppo.rollout.record` span (the step's transition and episode statistics
written into the rollout's buffer; no synchronise), over the window's
`ppo.rollout.step` spans (`perfbench/program_trace.py`)."""
from perfbench import program_trace

HOOKS = []


def read(run):
    return program_trace.host_us_per(run, "ppo.rollout.record", "ppo.rollout.step")
