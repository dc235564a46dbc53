"""Host microseconds a rollout step spends in the program's
`ppo.rollout.env` span (the engine's step: K6, K7 and K6 enqueued, the
output views made; no synchronise), over the window's `ppo.rollout.step`
spans (`perfbench/program_trace.py`)."""
from perfbench import program_trace

HOOKS = []


def read(run):
    return program_trace.host_us_per(run, "ppo.rollout.env", "ppo.rollout.step")
