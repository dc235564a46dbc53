"""Host microseconds a rollout step spends in the program's
`ppo.rollout.policy` span (the policy's forward, its sample and the stored
log-probability enqueued; no synchronise), over the window's
`ppo.rollout.step` spans (`perfbench/program_trace.py`)."""
from perfbench import program_trace

HOOKS = []


def read(run):
    return program_trace.host_us_per(run, "ppo.rollout.policy", "ppo.rollout.step")
